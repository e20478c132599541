"""Carry an AMG hierarchy across as plain arrays.

In AMG the hierarchy plays the part that weights play in a model: it is
built once (here or by any other setup) and the solve consumes it.
``hierarchy_from_numpy`` rebuilds the port's ``ParMultilevel`` from NumPy
arrays, so a hierarchy set up elsewhere runs through the port's
``DeviceHierarchy`` unchanged; ``bsr_hierarchy_from_numpy`` does the same
for a blocked hierarchy and ``BSRDeviceHierarchy``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.multilevel.bsr_hierarchy import ParBSRRugeStubenSolver
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel

# (indptr, indices, data, (n_rows, n_cols), row_bounds, col_bounds)
MatrixArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int],
                     np.ndarray, np.ndarray]
# (indptr, indices, data, (n_rows, n_cols)): an unpartitioned CSR matrix
CSRArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int]]


def csr_from_numpy(m: CSRArrays) -> CSRMatrix:
    indptr, indices, data, (n_rows, n_cols) = m
    return CSRMatrix(int(n_rows), int(n_cols),
                     np.asarray(indptr, dtype=np.int64),
                     np.asarray(indices, dtype=np.int64),
                     np.asarray(data, dtype=np.float64))


def matrix_from_numpy(m: MatrixArrays) -> ParCSRMatrix:
    """One row-partitioned CSR matrix from its arrays and shard bounds."""
    row_bounds, col_bounds = m[4:]
    csr = csr_from_numpy(m[:4])
    part = Partition(csr.n_rows, csr.n_cols, len(row_bounds) - 1,
                     np.asarray(row_bounds, dtype=np.int64),
                     np.asarray(col_bounds, dtype=np.int64))
    return ParCSRMatrix(csr, part)


def _levels_from_numpy(levels) -> list:
    if not levels or levels[-1][1] is not None:
        raise ValueError("the coarsest level must have no P")
    return [Level(A=matrix_from_numpy(a),
                  P=None if p is None else matrix_from_numpy(p))
            for a, p in levels]


def _coarse_lu(coarse_lu):
    lu, piv = coarse_lu
    return (np.asarray(lu, dtype=np.float64),
            np.asarray(piv, dtype=np.int64))


def hierarchy_from_numpy(
        levels: Sequence[Tuple[MatrixArrays, Optional[MatrixArrays]]],
        coarse_lu: Tuple[np.ndarray, np.ndarray],
        num_smooth_sweeps: int = 1,
        relax_type: RelaxType = RelaxType.Chebyshev,
        relax_weight: float = 1.0) -> ParMultilevel:
    """A ``ParMultilevel`` from per-level ``(A, P)`` arrays (P is None on
    the coarsest level) and scipy's ``lu_factor`` output ``(lu, piv)`` of
    the coarsest A, with 0-based pivots; smoothed by ``relax_type`` with
    ``num_smooth_sweeps`` sweeps (Chebyshev: its degree) and weight
    ``relax_weight``."""
    ml = ParMultilevel(relax_type=relax_type)
    ml.num_smooth_sweeps = num_smooth_sweeps
    ml.relax_weight = relax_weight
    ml.levels = _levels_from_numpy(levels)
    ml.coarse_lu = _coarse_lu(coarse_lu)
    return ml


def bsr_hierarchy_from_numpy(
        levels: Sequence[Tuple[MatrixArrays, Optional[MatrixArrays]]],
        p_nodals: Sequence[Sequence[CSRArrays]], block_size: int,
        coarse_lu: Tuple[np.ndarray, np.ndarray]) -> ParBSRRugeStubenSolver:
    """A blocked hierarchy that ``BSRDeviceHierarchy`` accepts, from
    per-level scalar ``(A, P)`` arrays (P is None on the coarsest level;
    the partitions on block boundaries), each level's ``block_size`` nodal
    component prolongators, and scipy's ``lu_factor`` output of the
    coarsest A, with 0-based pivots."""
    ml = ParBSRRugeStubenSolver(block_size)
    ml.levels = _levels_from_numpy(levels)
    if len(p_nodals) != len(ml.levels) - 1 or any(
            len(comps) != block_size for comps in p_nodals):
        raise ValueError(f"need {block_size} nodal prolongators on each of "
                         f"the {len(ml.levels) - 1} levels above the "
                         f"coarsest")
    ml.p_nodals = [[csr_from_numpy(p) for p in comps] for comps in p_nodals]
    ml.coarse_lu = _coarse_lu(coarse_lu)
    return ml
