"""Galerkin-product sparsification (copy of raptor_tpu.linalg.sparsify;
multilevel/par_sparsify.cpp:7-186, arXiv:1512.04629): drop small Ac
entries outside the minimal pattern M = (AP)^T I + (AI)^T P, folding the
dropped values into the diagonal so that row sums are preserved. Host
only (scipy), so the result equals the JAX package's exactly."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import CFState


def injection_matrix(states: np.ndarray) -> CSRMatrix:
    """I[i, coarse(i)] = 1 for C points (test_par_sparsify.cpp:96-113)."""
    n = len(states)
    sel = np.asarray(states) == CFState.Selected
    coarse_idx = np.cumsum(sel) - 1
    rows = np.nonzero(sel)[0]
    m = sp.csr_matrix((np.ones(len(rows)), (rows, coarse_idx[rows])),
                      shape=(n, int(sel.sum())))
    return CSRMatrix.from_scipy(m)


def sparsify(a: ParCSRMatrix, p: ParCSRMatrix, i_mat: CSRMatrix,
             ap: ParCSRMatrix, ac: ParCSRMatrix,
             theta: float, symmetric: bool = True) -> ParCSRMatrix:
    """The sparsified coarse operator: an off-diagonal entry of Ac stays
    when it is in M or at least ``theta`` times its row's largest
    off-diagonal magnitude.

    ``symmetric=True`` (the default, beyond the reference) keeps an entry
    when either (i, j) or (j, i) survives that one-sided rule, so a
    symmetric Ac stays symmetric (the reference's row-wise drop leaves
    |Ac - Ac^T| up to O(1) at theta 0.4 on 3-D PMIS + extended+i, which
    SPD smoothers and PCG do not survive); ``symmetric=False`` is the
    reference's rule."""
    isp = i_mat.to_scipy()
    m1 = ap.global_csr.to_scipy().T @ isp
    ai = a.global_csr.to_scipy() @ isp
    m2 = ai.T @ p.global_csr.to_scipy()
    m_pat = (m1 + m2).tocsr()
    m_pat.sum_duplicates()

    acm = ac.global_csr.to_scipy().tocsr()
    acm.sort_indices()
    n = acm.shape[0]
    indptr, indices, data = acm.indptr, acm.indices, acm.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    offd = indices != rows

    # each row's largest off-diagonal magnitude
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows[offd], np.abs(data[offd]))

    # membership in the minimal pattern, by (row, col) key
    mb = m_pat.tocsr()
    mb.sort_indices()
    mrows = np.repeat(np.arange(n), np.diff(mb.indptr))
    bkey = mrows.astype(np.int64) * acm.shape[1] + mb.indices
    akey = rows.astype(np.int64) * acm.shape[1] + indices
    pos = np.searchsorted(bkey, akey)
    pos = np.clip(pos, 0, max(0, len(bkey) - 1))
    in_m = (len(bkey) > 0) & (bkey[pos] == akey)

    keep = (~offd) | in_m | (np.abs(data) >= theta * row_max[rows])
    if symmetric:
        # OR the keep mask with its transpose; Ac's pattern is symmetric
        # for a symmetric A, so the two masks align entry by entry
        km = sp.csr_matrix((keep.astype(np.int8), indices, indptr),
                           shape=acm.shape)
        kmt = km.T.tocsr()
        kmt.sort_indices()
        if (np.array_equal(kmt.indptr, indptr)
                and np.array_equal(kmt.indices, indices)):
            keep = keep | (kmt.data > 0)
    dropped = ~keep
    # the dropped values go to the diagonal (row sums preserved)
    diag_add = np.zeros(n)
    np.add.at(diag_add, rows[dropped], data[dropped])

    out = sp.csr_matrix((data[keep], (rows[keep], indices[keep])),
                        shape=acm.shape)
    out = (out + sp.diags(diag_add)).tocsr()
    out.sum_duplicates()
    out.sort_indices()
    return ParCSRMatrix(CSRMatrix.from_scipy(out), ac.partition)
