"""Host-side (setup-phase) CSR and BSR containers (copy of
raptor_tpu.core.matrix, CSR and BSR only).

Equivalent of the reference's serial ``CSRMatrix`` (core/matrix.hpp:619) and
``BSRMatrix`` (core/matrix.hpp:962-1078) as NumPy structs of arrays. The
solve phase uses the padded device formats in ``raptor_tpu_torch.device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.types import ZERO_TOL


@dataclasses.dataclass
class CSRMatrix:
    """Compressed sparse row. ``indptr``/``indices``/``data`` mirror the
    reference's ``idx1``/``idx2``/``vals``."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @staticmethod
    def empty(n_rows: int, n_cols: int) -> "CSRMatrix":
        return CSRMatrix(n_rows, n_cols,
                         np.zeros(n_rows + 1, dtype=np.int64),
                         np.zeros(0, dtype=np.int64),
                         np.zeros(0, dtype=np.float64))

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = sp.csr_matrix(m)
        return CSRMatrix(m.shape[0], m.shape[1],
                         m.indptr.astype(np.int64, copy=False),
                         m.indices.astype(np.int64, copy=False),
                         m.data.astype(np.float64, copy=False))

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (self.data, self.indices, self.indptr),
            shape=(self.n_rows, self.n_cols))

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    def copy(self) -> "CSRMatrix":
        return CSRMatrix(self.n_rows, self.n_cols, self.indptr.copy(),
                         self.indices.copy(), self.data.copy())

    def sort(self) -> "CSRMatrix":
        """Sort column indices within each row (matrix.cpp:650-846).
        In-place; returns self."""
        rows = self.row_ids()
        order = np.lexsort((self.indices, rows))
        self.indices = self.indices[order]
        self.data = self.data[order]
        self._sorted_indices = True
        return self

    def canonicalize(self) -> "CSRMatrix":
        """Sorted columns + duplicates summed (remove_duplicates semantics,
        matrix.cpp:878-1073)."""
        m = self.to_scipy()
        m.sum_duplicates()
        m.sort_indices()
        return CSRMatrix.from_scipy(m)

    def drop(self, tol: float = ZERO_TOL) -> "CSRMatrix":
        """Remove entries with |v| <= tol, keeping order."""
        keep = np.abs(self.data) > tol
        kept_before = np.concatenate(
            ([0], np.cumsum(keep, dtype=np.int64)))
        return CSRMatrix(self.n_rows, self.n_cols, kept_before[self.indptr],
                         self.indices[keep], self.data[keep])

    def mult(self, x: np.ndarray) -> np.ndarray:
        """b = A x (CSR_spmv, util/linalg/spmv.cpp:59)."""
        return self.to_scipy() @ x

    def transpose(self) -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def multiply(self, other: "CSRMatrix") -> "CSRMatrix":
        """C = A B with |c_ij| <= zero_tol dropped (the reference's
        Gustavson accumulator drop rule, util/linalg/matmult.cpp:90-157),
        through the native kernel."""
        from raptor_tpu_torch import native
        indptr, indices, data = native.spgemm(
            self.n_rows, other.n_cols, self.indptr, self.indices,
            self.data, other.indptr, other.indices, other.data, ZERO_TOL)
        return CSRMatrix(self.n_rows, other.n_cols, indptr, indices, data)

    def T_multiply(self, other: "CSRMatrix") -> "CSRMatrix":
        """C = A^T B without materializing A^T (transpose-SpGEMM,
        util/linalg/matmult.cpp:158-226). Canonical output."""
        from raptor_tpu_torch import native
        indptr, indices, data = native.spgemm_T(
            self.n_rows, self.n_cols, other.n_cols, self.indptr,
            self.indices, self.data, other.indptr, other.indices,
            other.data, ZERO_TOL)
        return CSRMatrix(self.n_cols, other.n_cols, indptr, indices, data)

    def add(self, other: "CSRMatrix") -> "CSRMatrix":
        c = (self.to_scipy() + other.to_scipy()).tocsr()
        c.sort_indices()
        return CSRMatrix.from_scipy(c)

    def diagonal(self) -> np.ndarray:
        rows = self.row_ids()
        on_diag = self.indices == rows
        diag = np.zeros(min(self.n_rows, self.n_cols))
        # duplicate (i,i) entries sum (remove_duplicates semantics)
        np.add.at(diag, self.indices[on_diag], self.data[on_diag])
        return diag

    def row_ids(self) -> np.ndarray:
        """COO-style row id per stored entry (CSR order)."""
        return np.repeat(np.arange(self.n_rows), np.diff(self.indptr))

    def has_sorted_indices(self) -> bool:
        """Columns ascending within each row. Cached: CSR arrays are
        treated as immutable."""
        cached = getattr(self, "_sorted_indices", None)
        if cached is None:
            bad = np.flatnonzero(np.diff(self.indices) < 0) + 1
            cached = (len(bad) == 0
                      or bool(np.isin(bad, self.indptr).all()))
            self._sorted_indices = cached
        return cached

    def sorted_csr(self):
        """``(indptr, indices, data)`` with per-row ascending columns: the
        raw arrays when already sorted, a sorted copy otherwise."""
        if self.has_sorted_indices():
            return self.indptr, self.indices, self.data
        m = sp.csr_matrix((self.data.copy(), self.indices.copy(),
                           self.indptr), shape=(self.n_rows, self.n_cols))
        m.sort_indices()
        return (m.indptr.astype(np.int64, copy=False),
                m.indices.astype(np.int64, copy=False), m.data)

    def filter_entries(self, keep: np.ndarray) -> "CSRMatrix":
        """New CSR keeping only entries where ``keep`` (aligned with data)."""
        if keep.all():
            return CSRMatrix(self.n_rows, self.n_cols, self.indptr,
                             self.indices, self.data)
        kept_before = np.concatenate(([0], np.cumsum(keep, dtype=np.int64)))
        return CSRMatrix(self.n_rows, self.n_cols, kept_before[self.indptr],
                         self.indices[keep], self.data[keep])

    def row_slice(self, start: int, stop: int) -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy()[start:stop])

    def col_slice(self, start: int, stop: int) -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy()[:, start:stop])

    def to_dense(self) -> np.ndarray:
        return np.asarray(self.to_scipy().todense())


@dataclasses.dataclass
class BSRMatrix:
    """Block sparse row with dense b_rows x b_cols blocks
    (core/matrix.hpp:962-1078). Block values are a dense
    [n_blocks, b_rows, b_cols] array."""

    n_rows: int     # scalar rows
    n_cols: int     # scalar cols
    b_rows: int
    b_cols: int
    indptr: np.ndarray   # over block rows
    indices: np.ndarray  # block col ids
    blocks: np.ndarray   # [n_blocks, b_rows, b_cols]

    @property
    def n_block_rows(self) -> int:
        return self.n_rows // self.b_rows

    @property
    def n_block_cols(self) -> int:
        return self.n_cols // self.b_cols

    @property
    def nnz(self) -> int:
        """Scalar nnz (counting all entries of stored blocks)."""
        return self.blocks.size

    @staticmethod
    def from_csr(a: CSRMatrix, b_rows: int, b_cols: int) -> "BSRMatrix":
        """CSR -> BSR conversion (core/matrix.cpp:1099-1316 ``to_BSR``)."""
        m = a.to_scipy().tobsr(blocksize=(b_rows, b_cols))
        return BSRMatrix(a.n_rows, a.n_cols, b_rows, b_cols,
                         m.indptr.astype(np.int64),
                         m.indices.astype(np.int64),
                         np.asarray(m.data, dtype=np.float64))

    def to_csr(self) -> CSRMatrix:
        m = self.to_scipy().tocsr()
        m.sort_indices()
        return CSRMatrix.from_scipy(m)

    def to_scipy(self) -> sp.bsr_matrix:
        return sp.bsr_matrix((self.blocks, self.indices, self.indptr),
                             shape=(self.n_rows, self.n_cols))

    def mult(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def mult_T(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy().T @ x
