"""Carry an AMG hierarchy across as plain arrays.

In AMG the hierarchy plays the part that weights play in a model: it is
built once (here or by any other setup) and the solve consumes it.
``hierarchy_from_numpy`` rebuilds the port's ``ParMultilevel`` from NumPy
arrays, so a hierarchy set up elsewhere runs through the port's
``DeviceHierarchy`` unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel

# (indptr, indices, data, (n_rows, n_cols), row_bounds, col_bounds)
MatrixArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[int, int],
                     np.ndarray, np.ndarray]


def matrix_from_numpy(m: MatrixArrays) -> ParCSRMatrix:
    """One row-partitioned CSR matrix from its arrays and shard bounds."""
    indptr, indices, data, (n_rows, n_cols), row_bounds, col_bounds = m
    csr = CSRMatrix(int(n_rows), int(n_cols),
                    np.asarray(indptr, dtype=np.int64),
                    np.asarray(indices, dtype=np.int64),
                    np.asarray(data, dtype=np.float64))
    part = Partition(int(n_rows), int(n_cols), len(row_bounds) - 1,
                     np.asarray(row_bounds, dtype=np.int64),
                     np.asarray(col_bounds, dtype=np.int64))
    return ParCSRMatrix(csr, part)


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
    if not levels or levels[-1][1] is not None:
        raise ValueError("the coarsest level must have no P")
    ml = ParMultilevel(relax_type=relax_type)
    ml.num_smooth_sweeps = num_smooth_sweeps
    ml.relax_weight = relax_weight
    ml.levels = [Level(A=matrix_from_numpy(a),
                       P=None if p is None else matrix_from_numpy(p))
                 for a, p in levels]
    lu, piv = coarse_lu
    ml.coarse_lu = (np.asarray(lu, dtype=np.float64),
                    np.asarray(piv, dtype=np.int64))
    return ml
