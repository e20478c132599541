"""Shared set-up of the parity tests between raptor_tpu (JAX) and its
PyTorch port raptor_tpu_torch: one JAX hierarchy per (grid, shard count),
and the conversion of its matrices into the port's containers through
``raptor_tpu_torch.convert``."""

import functools

import numpy as np

from raptor_tpu.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu.gallery.stencils import diffusion_stencil_2d, par_stencil_grid
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
