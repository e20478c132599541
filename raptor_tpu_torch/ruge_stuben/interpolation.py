"""Modified-classical and extended+i interpolation (copy of
raptor_tpu.ruge_stuben.interpolation: the native host kernels, the
row-sum-preserving filter and the ``par_interpolation`` partition rule).

The native kernels have the production (parallel) semantics of the
reference's par_interpolation.cpp (:301-1010 extended+i, :1012-1400
modified classical); they run globally on the host, so the result does not
depend on the shard count. The device interpolation engines belong to a
later slice of the port.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import ZERO_TOL, CFState

S_ = CFState.Selected


def _coarse_map(states):
    """Global col -> coarse col index for Selected points."""
    sel = states == S_
    col_to_new = np.cumsum(sel) - 1
    return np.where(sel, col_to_new, -1), int(sel.sum())


def _strong_flags(a: CSRMatrix, s: CSRMatrix):
    """A's sorted CSR arrays and int8 flags of its entries that are in S."""
    a_indptr, a_indices, a_data = a.sorted_csr()
    s_indptr, s_indices, _ = s.sorted_csr()
    strong = native.mark_strong(a_indptr, a_indices, s_indptr, s_indices,
                                a.n_rows)
    return a_indptr, a_indices, a_data, strong


def mod_classical_interpolation(a: CSRMatrix, s: CSRMatrix,
                                states: np.ndarray) -> CSRMatrix:
    """For each F row i with weak sum w_i (diag + weak non-isolated
    entries), distribute each strong-F neighbor's value over
    the strong-C entries it shares with row i (entries of sign opposite to
    its diagonal), then scale by -1/w_i."""
    n = a.n_rows
    col_to_new, n_coarse = _coarse_map(states)
    a_indptr, a_indices, a_data, strong = _strong_flags(a, s)
    rows, cols, vals = native.mod_classical_interp(
        a_indptr, a_indices, a_data, strong,
        np.ascontiguousarray(states, dtype=np.int64))
    # entries come row-ordered, unique and column-ascending
    indptr, cols, vals = native.finalize_interp(n, rows, cols, vals,
                                                col_to_new, do_sort=False)
    return CSRMatrix(n, n_coarse, indptr, cols, vals)


def extended_interpolation(a: CSRMatrix, s: CSRMatrix,
                           states: np.ndarray) -> CSRMatrix:
    """Extended+i (distance-2) interpolation with the production semantics
    of par_interpolation.cpp:301-1010: P's row pattern is the strong C
    neighbours of i and those of its strong F neighbours; each strong F
    neighbour's value is spread over that pattern, with the "+i" term
    folding A_(col,i) back into the weak sum. Weak entries whose column is
    in the pattern add to that coefficient (:727-732), NoNeighbors columns
    stay out of the weak sum (:835), and the division by the weak sum is
    guarded by zero_tol (:949)."""
    n = a.n_rows
    col_to_new, n_coarse = _coarse_map(states)
    a_indptr, a_indices, a_data, strong = _strong_flags(a, s)
    states64 = np.ascontiguousarray(states, dtype=np.int64)
    bound = native.interp_pattern_bound(a_indptr, a_indices, strong,
                                        states64)
    rows, cols, vals = native.extended_interp(a_indptr, a_indices, a_data,
                                              strong, states64, bound)
    # the pattern is discovered out of order: sort within each row
    indptr, cols, vals = native.finalize_interp(n, rows, cols, vals,
                                                col_to_new, do_sort=True)
    return CSRMatrix(n, n_coarse, indptr, cols, vals)


def filter_interp(p: CSRMatrix, filter_threshold: float) -> CSRMatrix:
    """Drop P entries below filter_threshold * row max magnitude, preserving
    row sums (par_interpolation.cpp:196-299)."""
    if filter_threshold <= 0:
        return p
    m = p.to_scipy().tocoo()
    n = p.n_rows
    row_max = np.zeros(n)
    np.maximum.at(row_max, m.row, np.abs(m.data))
    keep = np.abs(m.data) >= filter_threshold * row_max[m.row]
    # preserve row sums: scale kept entries by old/new row sum
    old_sum = np.zeros(n)
    np.add.at(old_sum, m.row, m.data)
    new_sum = np.zeros(n)
    np.add.at(new_sum, m.row[keep], m.data[keep])
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(np.abs(new_sum) > ZERO_TOL, old_sum / new_sum, 1.0)
    out = sp.csr_matrix((m.data[keep] * scale[m.row[keep]],
                         (m.row[keep], m.col[keep])), shape=m.shape)
    out.sort_indices()
    return CSRMatrix.from_scipy(out)


_KINDS = {"mod_classical": mod_classical_interpolation,
          "extended": extended_interpolation}


def par_interpolation(a: ParCSRMatrix, s: ParCSRMatrix, states,
                      kind: str = "mod_classical") -> ParCSRMatrix:
    """P of the given ``kind`` ("mod_classical" or "extended") with the
    reference's partition: A's rows, and coarse columns owned where their
    fine C-points live."""
    if kind not in _KINDS:
        raise ValueError(f"interpolation kind {kind!r}; the port runs "
                         f"{sorted(_KINDS)}")
    p = _KINDS[kind](a.global_csr, s.global_csr, states)
    row_bounds = a.partition.row_bounds
    csum = np.concatenate([[0], np.cumsum(np.asarray(states) == S_)])
    part = Partition(a.global_num_rows, p.n_cols, a.partition.n_shards,
                     row_bounds, csum[row_bounds].astype(np.int64))
    return ParCSRMatrix(p, part)
