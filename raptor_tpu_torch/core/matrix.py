"""Host-side (setup-phase) sparse matrix containers (copy of
raptor_tpu.core.matrix).

Equivalent of the reference's serial ``Matrix`` hierarchy
(core/matrix.hpp:56-1309: COOMatrix / CSRMatrix / CSCMatrix / BSRMatrix /
BCOOMatrix / BSCMatrix) as NumPy structs of arrays, with its semantics:
``sort`` + ``remove_duplicates`` sum duplicate entries
(core/matrix.cpp:650-846, 878-1073), and the format conversions between
COO / CSR / CSC / BSR (core/matrix.cpp:1099-1316). The solve phase uses
the padded device formats in ``raptor_tpu_torch.device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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

    def canonicalize(self, drop_tol: Optional[float] = None) -> "CSRMatrix":
        """Sorted columns + duplicates summed (remove_duplicates semantics,
        matrix.cpp:878-1073); optionally |v| <= drop_tol entries dropped.
        The arrays of ``self`` stay as they are (scipy sums and sorts in
        place, so a matrix that is not canonical is copied first)."""
        m = self.to_scipy()
        if not m.has_canonical_format:
            m = m.copy()
            m.sum_duplicates()
            m.sort_indices()
        out = CSRMatrix.from_scipy(m)
        if drop_tol is not None:
            out = out.drop(drop_tol)
        return out

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

    def mult_T(self, x: np.ndarray) -> np.ndarray:
        """b = A^T x (CSR_append_T, util/linalg/spmv.cpp:168)."""
        return self.to_scipy().T @ x

    def residual(self, x: np.ndarray, b: np.ndarray) -> np.ndarray:
        return b - self.mult(x)

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

    def subtract(self, other: "CSRMatrix") -> "CSRMatrix":
        c = (self.to_scipy() - other.to_scipy()).tocsr()
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
class COOMatrix:
    """Coordinate format (core/matrix.hpp:432)."""

    n_rows: int
    n_cols: int
    row: np.ndarray
    col: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return len(self.data)

    def to_csr(self) -> CSRMatrix:
        """CSR with duplicates summed (scipy's COO -> CSR, as
        remove_duplicates_helper, core/matrix.cpp:878) and sorted columns."""
        m = sp.csr_matrix(
            (self.data, (self.row, self.col)),
            shape=(self.n_rows, self.n_cols))
        m.sum_duplicates()
        m.sort_indices()
        return CSRMatrix.from_scipy(m)

    @staticmethod
    def from_csr(a: CSRMatrix) -> "COOMatrix":
        return COOMatrix(a.n_rows, a.n_cols, a.row_ids(), a.indices.copy(),
                         a.data.copy())


@dataclasses.dataclass
class CSCMatrix:
    """Compressed sparse column (core/matrix.hpp:808), for the setup's
    column-driven passes."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray   # over columns
    indices: np.ndarray  # row ids
    data: np.ndarray

    @staticmethod
    def from_csr(a: CSRMatrix) -> "CSCMatrix":
        m = a.to_scipy().tocsc()
        m.sort_indices()
        return CSCMatrix(a.n_rows, a.n_cols, m.indptr.astype(np.int64),
                         m.indices.astype(np.int64),
                         m.data.astype(np.float64))

    def to_scipy(self) -> sp.csc_matrix:
        return sp.csc_matrix((self.data, self.indices, self.indptr),
                             shape=(self.n_rows, self.n_cols))

    def to_csr(self) -> CSRMatrix:
        m = self.to_scipy().tocsr()
        m.sort_indices()
        return CSRMatrix.from_scipy(m)

    @property
    def nnz(self) -> int:
        return len(self.indices)

    def mult(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def transpose(self) -> CSRMatrix:
        """A^T as CSR: the CSC arrays of A are the CSR arrays of A^T."""
        return CSRMatrix(self.n_cols, self.n_rows, self.indptr.copy(),
                         self.indices.copy(), self.data.copy())


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


@dataclasses.dataclass
class BCOOMatrix:
    """Blocked coordinate format (core/matrix.hpp:1078): the blocked
    assembly container; converts through BSR for compute."""

    n_rows: int
    n_cols: int
    b_rows: int
    b_cols: int
    row: np.ndarray      # block row ids
    col: np.ndarray      # block col ids
    blocks: np.ndarray   # [n_blocks, b_rows, b_cols]

    def to_bsr(self) -> BSRMatrix:
        """BSR with duplicate (row, col) blocks summed (remove_duplicates
        semantics): blocks sorted by (row, col), each run of equal keys
        summed in that order."""
        nbr = self.n_rows // self.b_rows
        nbc = self.n_cols // self.b_cols
        order = np.lexsort((self.col, self.row))
        r, c = self.row[order], self.col[order]
        blk = np.asarray(self.blocks, dtype=np.float64)[order]
        key = r * nbc + c
        uniq, first = np.unique(key, return_index=True)
        summed = np.add.reduceat(blk, first, axis=0)
        ur, uc = uniq // nbc, uniq % nbc
        indptr = np.concatenate(
            ([0], np.cumsum(np.bincount(ur, minlength=nbr),
                            dtype=np.int64)))
        return BSRMatrix(self.n_rows, self.n_cols, self.b_rows,
                         self.b_cols, indptr, uc.astype(np.int64), summed)

    @staticmethod
    def from_bsr(a: BSRMatrix) -> "BCOOMatrix":
        rows = np.repeat(np.arange(a.n_block_rows), np.diff(a.indptr))
        return BCOOMatrix(a.n_rows, a.n_cols, a.b_rows, a.b_cols, rows,
                          a.indices.copy(), a.blocks.copy())


@dataclasses.dataclass
class BSCMatrix:
    """Blocked compressed sparse column (core/matrix.hpp:1195): the BSC
    arrays of A are the BSR arrays of A^T with transposed blocks."""

    n_rows: int
    n_cols: int
    b_rows: int
    b_cols: int
    indptr: np.ndarray   # over block cols
    indices: np.ndarray  # block row ids
    blocks: np.ndarray   # [n_blocks, b_rows, b_cols]

    @staticmethod
    def from_bsr(a: BSRMatrix) -> "BSCMatrix":
        t = a.to_scipy().T.tobsr(blocksize=(a.b_cols, a.b_rows))
        return BSCMatrix(a.n_rows, a.n_cols, a.b_rows, a.b_cols,
                         t.indptr.astype(np.int64),
                         t.indices.astype(np.int64),
                         np.transpose(np.asarray(t.data, np.float64),
                                      (0, 2, 1)))

    def to_bsr(self) -> BSRMatrix:
        tb = sp.bsr_matrix(
            (np.transpose(self.blocks, (0, 2, 1)), self.indices,
             self.indptr),
            shape=(self.n_cols, self.n_rows),
            blocksize=(self.b_cols, self.b_rows))
        m = tb.T.tobsr(blocksize=(self.b_rows, self.b_cols))
        m.sort_indices()
        return BSRMatrix(self.n_rows, self.n_cols, self.b_rows,
                         self.b_cols, m.indptr.astype(np.int64),
                         m.indices.astype(np.int64),
                         np.asarray(m.data, dtype=np.float64))


def compare(a: CSRMatrix, b: CSRMatrix, atol: float = 1e-6,
            pattern_only: bool = False) -> None:
    """Exact-pattern / value-tolerance comparison (the reference test
    helper ``compare``, raptor/tests/compare.hpp:16-69); raises
    AssertionError on a mismatch, as the JAX package's does."""
    ac = a.canonicalize(drop_tol=0.0)
    bc = b.canonicalize(drop_tol=0.0)
    if not (ac.n_rows == bc.n_rows and ac.n_cols == bc.n_cols):
        raise AssertionError(f"shape mismatch {(ac.n_rows, ac.n_cols)} vs "
                             f"{(bc.n_rows, bc.n_cols)}")
    if not np.array_equal(ac.indptr, bc.indptr):
        raise AssertionError("row pattern mismatch")
    if not np.array_equal(ac.indices, bc.indices):
        raise AssertionError("col pattern mismatch")
    if not pattern_only:
        err = np.max(np.abs(ac.data - bc.data)) if ac.nnz else 0.0
        if not err <= atol:
            raise AssertionError(f"value mismatch: max err {err} > {atol}")
