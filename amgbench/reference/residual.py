"""The comparison that decides ``correct``: a solution's relative residual
against the matrix the benchmark built, in float64. NumPy and SciPy only.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def relative_residual(A: sp.csr_matrix, x: np.ndarray,
                      b: np.ndarray) -> float:
    """||b - A x||_2 / ||b||_2 in float64; infinity when ``x`` is not a
    finite vector of A's columns."""
    x = np.asarray(x)
    if x.shape != (A.shape[1],) or not np.isfinite(x).all():
        return float("inf")
    b = np.asarray(b, dtype=np.float64)
    r = b - A @ x.astype(np.float64, copy=False)
    return float(np.linalg.norm(r) / np.linalg.norm(b))
