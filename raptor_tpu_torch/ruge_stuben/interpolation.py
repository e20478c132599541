"""Modified-classical interpolation (copy of
raptor_tpu.ruge_stuben.interpolation: the native host kernel and the
``par_interpolation`` partition rule).

The native kernel has the production (parallel) semantics of the
reference's par_interpolation.cpp:1012-1400; it runs globally on the host,
so the result does not depend on the shard count.
"""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import CFState

S_ = CFState.Selected


def _coarse_map(states):
    """Global col -> coarse col index for Selected points."""
    sel = states == S_
    col_to_new = np.cumsum(sel) - 1
    return np.where(sel, col_to_new, -1), int(sel.sum())


def mod_classical_interpolation(a: CSRMatrix, s: CSRMatrix,
                                states: np.ndarray) -> CSRMatrix:
    """For each F row i with weak sum w_i (diag + weak non-isolated
    entries), distribute each strong-F neighbor's value over
    the strong-C entries it shares with row i (entries of sign opposite to
    its diagonal), then scale by -1/w_i."""
    n = a.n_rows
    col_to_new, n_coarse = _coarse_map(states)
    a_indptr, a_indices, a_data = a.sorted_csr()
    s_indptr, s_indices, _ = s.sorted_csr()
    strong_i8 = native.mark_strong(a_indptr, a_indices, s_indptr, s_indices,
                                   n)
    rows, cols, vals = native.mod_classical_interp(
        a_indptr, a_indices, a_data, strong_i8,
        np.ascontiguousarray(states, dtype=np.int64))
    # entries come row-ordered, unique and column-ascending
    indptr, cols, vals = native.finalize_interp(n, rows, cols, vals,
                                                col_to_new, do_sort=False)
    return CSRMatrix(n, n_coarse, indptr, cols, vals)


def par_interpolation(a: ParCSRMatrix, s: ParCSRMatrix,
                      states) -> ParCSRMatrix:
    """Modified-classical P with the reference's partition: A's rows, and
    coarse columns owned where their fine C-points live."""
    p = mod_classical_interpolation(a.global_csr, s.global_csr, states)
    row_bounds = a.partition.row_bounds
    csum = np.concatenate([[0], np.cumsum(np.asarray(states) == S_)])
    part = Partition(a.global_num_rows, p.n_cols, a.partition.n_shards,
                     row_bounds, csum[row_bounds].astype(np.int64))
    return ParCSRMatrix(p, part)
