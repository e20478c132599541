"""Diagonal scaling (copy of raptor_tpu.linalg.diag_scale;
util/linalg/par_diag_scale.cpp)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix


def row_scale(a: ParCSRMatrix, rhs: np.ndarray):
    """Jacobi row scaling: rows and rhs divided by the diagonal
    (par_diag_scale.cpp:7-29). Rows with no diagonal are zeroed, as in the
    reference (scale = 0)."""
    diag = a.global_csr.diagonal()
    scale = np.where(diag != 0.0, 1.0 / np.where(diag == 0, 1, diag), 0.0)
    m = sp.diags(scale) @ a.global_csr.to_scipy()
    return (ParCSRMatrix(CSRMatrix.from_scipy(m.tocsr()), a.partition),
            rhs * scale)


def diagonally_scale(a: ParCSRMatrix, rhs: np.ndarray):
    """Symmetric scaling D^{-1/2} A D^{-1/2} with D = |diag|
    (par_diag_scale.cpp:31-80). Returns (A_scaled, rhs_scaled, row_scales)
    so solutions can be unscaled; rows with no diagonal get scale 0."""
    diag = a.global_csr.diagonal()
    scales = np.where(diag != 0.0,
                      1.0 / np.sqrt(np.abs(np.where(diag == 0, 1, diag))),
                      0.0)
    d = sp.diags(scales)
    m = (d @ a.global_csr.to_scipy() @ d).tocsr()
    return (ParCSRMatrix(CSRMatrix.from_scipy(m), a.partition),
            rhs * scales, scales)


def diagonally_unscale(sol: np.ndarray, row_scales: np.ndarray) -> np.ndarray:
    """The solution of the unscaled system (par_diag_scale.cpp:74-80)."""
    return sol * row_scales
