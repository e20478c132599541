"""Shared set-up of the parity tests between raptor_tpu (JAX) and its
PyTorch port raptor_tpu_torch: one JAX hierarchy per (grid, shard count)
for the 2-D flagship and for the 3-D 27-point Laplacian, and the
conversion of its matrices into the port's containers through
``raptor_tpu_torch.convert``."""

import functools

import numpy as np

from raptor_tpu.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu.gallery.stencils import (
    diffusion_stencil_2d, laplace_stencil_27pt, par_stencil_grid)
from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver
from raptor_tpu_torch import convert

ANISO = (0.001, np.pi / 8)


def aniso(n: int, n_shards: int):
    """The flagship problem: 2-D rotated anisotropic diffusion on n x n."""
    return par_stencil_grid(diffusion_stencil_2d(*ANISO), (n, n), n_shards)


@functools.lru_cache(maxsize=None)
def jax_hierarchy(n: int, n_shards: int, sweeps: int = 3):
    """RS + modified classical, theta 0.25, Chebyshev: the flagship
    configuration, with the host engines (the port has no device setup)."""
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.rap_mode = ml.interp_mode = "host"
    ml.num_smooth_sweeps = sweeps
    ml.setup(aniso(n, n_shards))
    return ml


@functools.lru_cache(maxsize=None)
def jax_hierarchy3d(n: int, n_shards: int, coarsen: str = "PMIS",
                    max_levels: int = 25):
    """The 3-D configuration: 27-point Laplacian on n^3, PMIS or HMIS with
    extended+i (filtered at 0.3), theta 0.25, Chebyshev(2), host engines."""
    ml = ParRugeStubenSolver(0.25, getattr(CoarsenType, coarsen),
                             InterpType.Extended,
                             relax_type=RelaxType.Chebyshev)
    ml.rap_mode = ml.interp_mode = "host"
    ml.num_smooth_sweeps = 2
    ml.max_levels = max_levels
    ml.setup(par_stencil_grid(laplace_stencil_27pt(), (n, n, n), n_shards))
    return ml


def arrays(m):
    """A JAX-package ParCSRMatrix as convert.MatrixArrays."""
    g, part = m.global_csr, m.partition
    return (g.indptr, g.indices, g.data, (g.n_rows, g.n_cols),
            part.row_bounds, part.col_bounds)


def to_port(m):
    return convert.matrix_from_numpy(arrays(m))


def port_hierarchy(ml):
    """The JAX (Chebyshev) hierarchy carried across into the port."""
    assert ml.relax_type == RelaxType.Chebyshev
    levels = [(arrays(lvl.A), None if lvl.P is None else arrays(lvl.P))
              for lvl in ml.levels]
    return convert.hierarchy_from_numpy(levels, ml.coarse_lu,
                                        ml.num_smooth_sweeps)


def assert_same_matrix(t, j):
    """A port ParCSRMatrix equal to a JAX-package one: identical partition
    and pattern, values equal to 1e-12."""
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(t.partition, f),
                                      getattr(j.partition, f))
    tg, jg = t.global_csr, j.global_csr
    assert tg.shape == jg.shape
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    np.testing.assert_allclose(tg.data, jg.data, rtol=1e-12, atol=0)


def rhs(ml, ones=False):
    """b = A x for x = 1 or a seeded standard normal x."""
    a = ml.levels[0].A
    x = (np.ones(a.global_num_rows) if ones else
         np.random.default_rng(0).standard_normal(a.global_num_rows))
    return a.global_csr.to_scipy() @ x


@functools.lru_cache(maxsize=None)
def jax_solve3d(n: int, n_shards: int, lane_pad: int):
    """JAX's float64 V-cycle solve to 1e-9 of the 3-D PMIS hierarchy with
    b = A x_true: (cycles, residual history, stalled). Cached, because its
    compile takes tens of seconds on the CPU."""
    import jax.numpy as jnp
    from raptor_tpu.device import par as jpar
    from raptor_tpu.multilevel.device_hierarchy import DeviceHierarchy
    jml = jax_hierarchy3d(n, n_shards)
    jdh = DeviceHierarchy(jml, jpar.make_mesh(n_shards), dtype=jnp.float64,
                          lane_pad=lane_pad)
    jdh.solve_tol = 1e-9
    b = rhs(jml)
    r = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    return int(r.n_iters), np.asarray(r.res), bool(r.stalled)


def assert_same_history(tr, jref):
    """A port SolveResult against ``jax_solve3d``'s: equal cycle counts and
    residual histories equal to 1e-9 relative; entries below 1e-7 are held
    to 1e-16 absolute, since a relative residual r carries rounding of
    about 1e-16 / r of its own."""
    n_iters, res, stalled = jref
    assert tr.n_iters == n_iters > 3
    assert not tr.stalled and not stalled
    np.testing.assert_allclose(tr.res, res, rtol=1e-9, atol=1e-16)
