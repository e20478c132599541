"""RAP sparsification in the port (``linalg.sparsify``,
``ParRugeStubenSolver.sparsify_tol``) against the JAX package: the
injection matrix and one sparsified Galerkin product (symmetric and the
reference's one-sided rule) equal to JAX's exactly, and the hierarchies of
tests/test_multilevel.py::test_sparsify_tol_knob (25^2, 4 shards) and
::test_sparsify_symmetric_3d (16^3 PMIS + extended+i, 0.4, both rules)
bit for bit, solved in JAX's V-cycles. The distributed setup refuses the
knob.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.types import (  # noqa: E402
    CoarsenType as JC, InterpType as JI, RelaxType as JR,
    StrengthType as JS)
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.linalg import sparsify as jsp  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben.interpolation import (  # noqa: E402
    par_interpolation as jinterp)
from raptor_tpu.ruge_stuben.strength import strength as jstrength  # noqa
from raptor_tpu.utils.glibc_rand import form_rand_weights  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.linalg import sparsify as tsp  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as TRS)

from _torch_parity import ANISO, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


def _bytes_equal(t, j):
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices", "data"):
        assert getattr(t, f).tobytes() == getattr(j, f).tobytes(), f


def test_injection_matrix_matches_jax():
    states = np.random.default_rng(5).integers(0, 2, 500).astype(np.int64)
    got = tsp.injection_matrix(states)
    _bytes_equal(got, jsp.injection_matrix(states))
    assert got.nnz == got.n_cols == int(states.sum())


def _galerkin_inputs():
    """JAX's level-0 pieces of the 25^2 problem (4 shards, CLJP +
    modified classical): A, P, the CF states, AP and P^T A P."""
    a = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (25, 25), 4)
    s = jstrength(a, JS.Classical, 0.25)
    states = np.asarray(jcf.split_cljp(
        s, form_rand_weights(a.global_num_rows, 0)), dtype=np.int64)
    p = jinterp(a, s, states, "mod_classical")
    ap = a.multiply(p)
    return a, p, states, ap, p.mult_T_mat(ap)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("theta", [0.1, 0.4])
def test_sparsify_matches_jax(theta, symmetric):
    a, p, states, ap, ac = _galerkin_inputs()
    ref = jsp.sparsify(a, p, jsp.injection_matrix(states), ap, ac, theta,
                       symmetric)
    got = tsp.sparsify(to_port(a), to_port(p), tsp.injection_matrix(states),
                       to_port(ap), to_port(ac), theta, symmetric)
    _bytes_equal(got.global_csr, ref.global_csr)
    np.testing.assert_array_equal(got.partition.row_bounds,
                                  ac.partition.row_bounds)
    # entries dropped, row sums kept
    g, c = got.global_csr.to_scipy(), ac.global_csr.to_scipy()
    assert g.nnz < c.nnz
    np.testing.assert_allclose(g.sum(axis=1), c.sum(axis=1), rtol=0,
                               atol=1e-13 * abs(c).max())
    if symmetric:
        assert abs(g - g.T).max() <= 1e-13 * abs(c).max()


def _hierarchies(grid, n_shards, coarsen, interp, relax, sweeps, tol,
                 symmetric=True):
    """(port, JAX) hierarchies with ``sparsify_tol = tol``."""
    tml = TRS(0.25, getattr(CoarsenType, coarsen),
              getattr(InterpType, interp),
              relax_type=getattr(RelaxType, relax))
    jml = JRS(0.25, getattr(JC, coarsen), getattr(JI, interp),
              relax_type=getattr(JR, relax))
    for ml in (tml, jml):
        ml.rap_mode = ml.interp_mode = "host"
        ml.num_smooth_sweeps = sweeps
        ml.sparsify_tol = tol
        ml.sparsify_symmetric = symmetric
    if len(grid) == 2:
        tA = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), grid,
                                  n_shards)
        jA = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), grid,
                                  n_shards)
    else:
        tA = tst.par_stencil_grid(tst.laplace_stencil_27pt(), grid, n_shards)
        jA = jst.par_stencil_grid(jst.laplace_stencil_27pt(), grid, n_shards)
    tml.setup(tA)
    jml.setup(jA)
    assert tml.num_levels == jml.num_levels > 2
    for tl, jl in zip(tml.levels, jml.levels):
        _bytes_equal(tl.A.global_csr, jl.A.global_csr)
        if jl.P is not None:
            _bytes_equal(tl.P.global_csr, jl.P.global_csr)
    assert tml.setup_times.counts["sparsify"] == tml.num_levels - 1
    return tml, jml


def _same_solve(tml, jml, n_shards):
    """Both packages' float64 V-cycle solves from b = A 1: JAX's cycles,
    histories to 1e-9."""
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(n_shards),
                             dtype=jnp.float64)
    tdh = DeviceHierarchy(tml, dtype=torch.float64, device="cpu")
    b = jml.levels[0].A.mult(np.ones(jml.levels[0].A.global_num_rows))
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    tr = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b))
    assert tr.n_iters == int(jr.n_iters) < tml.max_iterations
    assert tr.res[tr.n_iters] < tml.solve_tol and not tr.stalled
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9,
                               atol=1e-16)


def test_sparsify_tol_knob_matches_jax():
    tml, jml = _hierarchies((25, 25), 4, "CLJP", "ModClassical", "SOR", 1,
                            0.25)
    plain = TRS(0.25, CoarsenType.CLJP, InterpType.ModClassical)
    plain.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO),
                                     (25, 25), 4))
    assert (sum(lvl.A.nnz for lvl in tml.levels[1:])
            < sum(lvl.A.nnz for lvl in plain.levels[1:]))
    _same_solve(tml, jml, 4)


@pytest.mark.parametrize("symmetric", [True, False])
def test_sparsify_3d_matches_jax(symmetric):
    tml, jml = _hierarchies((16, 16, 16), 4, "PMIS", "Extended",
                            "Chebyshev", 2, 0.4, symmetric)
    if symmetric:
        for lvl in tml.levels[1:]:
            m = lvl.A.global_csr.to_scipy()
            assert abs(m - m.T).max() < 1e-10
        _same_solve(tml, jml, 4)


def test_distributed_sparsify_raises_before_any_level():
    """Also with systems AMG on: the raise comes before any level."""
    ml = TRS(0.25, CoarsenType.CLJP, InterpType.ModClassical)
    ml.setup_mode = "distributed"
    ml.sparsify_tol = 0.4
    ml.num_variables = 2
    ml.variables = np.arange(36 * 36, dtype=np.int64) % 2
    with pytest.raises(NotImplementedError, match="global mode"):
        ml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO),
                                      (36, 36), 4))
    assert ml.levels == []
