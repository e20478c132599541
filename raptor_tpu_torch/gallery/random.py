"""Random sparse matrix gallery (copy of raptor_tpu.gallery.random;
gallery/par_random.cpp:6, gallery/random.cpp).

``nnz_per_row`` random entries per row with random values, duplicates
summed. Deterministic given ``seed``: the draws come from
``numpy.random.default_rng(seed)`` in the JAX package's order, so both
packages give the same matrix.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import (ParCSRMatrix,
                                              par_matrix_from_scipy)


def random_matrix(n_rows: int, n_cols: int, nnz_per_row: int = 5,
                  seed: int = 0) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), nnz_per_row)
    cols = rng.integers(0, n_cols, size=n_rows * nnz_per_row)
    vals = rng.random(n_rows * nnz_per_row)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n_rows, n_cols))
    m.sum_duplicates()
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def par_random(global_rows: int, global_cols: int, nnz_per_row: int,
               n_shards: int, seed: int = 0) -> ParCSRMatrix:
    a = random_matrix(global_rows, global_cols, nnz_per_row, seed)
    return par_matrix_from_scipy(a.to_scipy(), n_shards)
