"""Jacobi prolongation smoothing (copy of
raptor_tpu.aggregation.prolongation; aggregation/prolongation.cpp:6-58):
P = (I - w D~^{-1} A)^k T with D~ the |row sum| of |A|."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.types import ZERO_TOL


def jacobi_prolongation(a: CSRMatrix, t: CSRMatrix, omega: float = 4.0 / 3.0,
                        num_smooth_steps: int = 1) -> CSRMatrix:
    am = a.to_scipy()
    # the reference weights each row by the sum of its |a_ij|
    # (prolongation.cpp:20-33)
    abs_row_sums = np.asarray(np.abs(am).sum(axis=1)).ravel()
    inv = np.where(abs_row_sums != 0.0, omega / np.abs(abs_row_sums), 0.0)
    scaled_a = sp.diags(inv) @ am

    p = t.to_scipy()
    for _ in range(num_smooth_steps):
        ap = (scaled_a @ p).tocsr()
        ap.sum_duplicates()
        # the reference's SpGEMM drops |v| <= zero_tol
        # (matmult.cpp:90-157)
        ap.data[np.abs(ap.data) <= ZERO_TOL] = 0.0
        ap.eliminate_zeros()
        p = (p - ap).tocsr()
    p.sort_indices()
    return CSRMatrix.from_scipy(p)
