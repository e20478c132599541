"""Tentative prolongator from near-nullspace candidates (copy of
raptor_tpu.aggregation.candidates; aggregation/candidates.cpp:7-141).

A thin QR of each aggregate's block of candidates; with one candidate this
is a column normalisation. R holds the coarse level's candidates."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix


def fit_candidates(n_aggs: int, aggregates: np.ndarray, b: np.ndarray,
                   num_candidates: int = 1, tol: float = 1e-10):
    """Returns (T [n x n_aggs*num_candidates], R coarse candidates)."""
    n = len(aggregates)
    b = np.asarray(b, dtype=np.float64).reshape(num_candidates, n)

    if num_candidates == 1:
        # one candidate: each aggregate's column normalised, vectorised
        b1 = b[0]
        rows = np.flatnonzero(aggregates >= 0)
        ag = aggregates[rows].astype(np.int64)
        nrm = np.sqrt(np.bincount(ag, weights=b1[rows] ** 2,
                                  minlength=n_aggs))
        # nrm > ||col||*tol is false only for an exactly zero column
        safe = np.where(nrm > 0.0, nrm, 1.0)
        vals = np.where(nrm[ag] > 0.0, b1[rows] / safe[ag], 0.0)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(aggregates >= 0, out=indptr[1:])
        return (CSRMatrix(n, n_aggs, indptr, ag, vals), nrm.copy())

    # several candidates: Gram-Schmidt per aggregate
    rows_l, cols_l, vals_l = [], [], []
    R = np.zeros(n_aggs * num_candidates * num_candidates)
    order = np.argsort(aggregates, kind="stable")
    bounds = np.searchsorted(aggregates[order], np.arange(n_aggs + 1))
    for agg in range(n_aggs):
        rows = order[bounds[agg]:bounds[agg + 1]]
        block = b[:, rows].T.copy()          # [rows, num_candidates]
        idx_r = agg * num_candidates * num_candidates
        for j in range(num_candidates):
            col = block[:, j]
            thr = np.linalg.norm(col) * tol
            for k in range(j):
                dp = block[:, k] @ col
                col -= dp * block[:, k]
                R[idx_r + k * num_candidates + j] = dp
            nrm = np.linalg.norm(col)
            if nrm > thr:
                col /= nrm
                R[idx_r + j * num_candidates + j] = nrm
            else:
                col[:] = 0.0
                R[idx_r + j * num_candidates + j] = 0.0
            rows_l.append(rows)
            cols_l.append(np.full(len(rows), agg * num_candidates + j))
            vals_l.append(col.copy())

    t = sp.csr_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, n_aggs * num_candidates))
    t.sort_indices()
    return CSRMatrix.from_scipy(t), R
