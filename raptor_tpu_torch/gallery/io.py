"""Matrix file I/O: PETSc binary ``.pm`` and MatrixMarket ``.mtx`` (copy of
raptor_tpu.gallery.io).

Equivalents of the reference's readers (gallery/par_matrix_IO.cpp:25-187,
gallery/matrix_market.cpp:23,84). The ``.pm`` format is PETSc's binary Mat:
an int32 header [classid=1211216, rows, cols, nnz], then ``rows`` int32
per-row nnz counts, then ``nnz`` int32 column indices, then ``nnz``
float64 values. PETSc writes big-endian; ``read_pm`` also takes the
little-endian files some tools write, and ``write_pm`` writes big-endian.
"""

from __future__ import annotations

import numpy as np
import scipy.io
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import (ParCSRMatrix,
                                              par_matrix_from_scipy)

PETSC_MAT_CODE = 1211216


def read_pm(filename) -> CSRMatrix:
    """Read a PETSc binary sparse matrix (par_matrix_IO.cpp:25-187), in
    either byte order; duplicates summed, indices sorted."""
    with open(filename, "rb") as f:
        raw = f.read()
    header = np.frombuffer(raw, dtype=">i4", count=4)
    if header[0] != PETSC_MAT_CODE:
        header = np.frombuffer(raw, dtype="<i4", count=4)
        if header[0] != PETSC_MAT_CODE:
            raise ValueError(f"{filename}: not a PETSc binary matrix")
        i4, f8 = "<i4", "<f8"
    else:
        i4, f8 = ">i4", ">f8"
    _, n_rows, n_cols, nnz = (int(v) for v in header)
    off = 16
    row_sizes = np.frombuffer(raw, dtype=i4, count=n_rows, offset=off)
    off += 4 * n_rows
    col_idx = np.frombuffer(raw, dtype=i4, count=nnz, offset=off)
    off += 4 * nnz
    vals = np.frombuffer(raw, dtype=f8, count=nnz, offset=off)

    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_sizes, out=indptr[1:])
    m = sp.csr_matrix(
        (vals.astype(np.float64), col_idx.astype(np.int64), indptr),
        shape=(n_rows, n_cols))
    m.sum_duplicates()
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def write_pm(filename, a: CSRMatrix) -> None:
    """Write PETSc binary format, big-endian as PETSc does."""
    m = a.canonicalize()
    with open(filename, "wb") as f:
        np.array([PETSC_MAT_CODE, m.n_rows, m.n_cols, m.nnz],
                 dtype=">i4").tofile(f)
        np.diff(m.indptr).astype(">i4").tofile(f)
        m.indices.astype(">i4").tofile(f)
        m.data.astype(">f8").tofile(f)


def read_par_pm(filename, n_shards: int) -> ParCSRMatrix:
    """``read_pm`` over the contiguous block partition into ``n_shards``."""
    return par_matrix_from_scipy(read_pm(filename).to_scipy(), n_shards)


def read_mm(filename) -> CSRMatrix:
    """Read MatrixMarket (gallery/matrix_market.cpp:23)."""
    m = sp.csr_matrix(scipy.io.mmread(filename))
    m.sum_duplicates()
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def write_mm(filename, a: CSRMatrix) -> None:
    """Write MatrixMarket (gallery/matrix_market.cpp:84)."""
    scipy.io.mmwrite(filename, a.to_scipy())


def read_par_mm(filename, n_shards: int) -> ParCSRMatrix:
    """``read_mm`` over the contiguous block partition into ``n_shards``."""
    return par_matrix_from_scipy(read_mm(filename).to_scipy(), n_shards)
