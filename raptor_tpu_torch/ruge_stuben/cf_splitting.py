"""CF splitting: Ruge-Stuben and Falgout, with the CLJP loop Falgout runs
(copy of raptor_tpu.ruge_stuben.cf_splitting, native paths only).

Run globally on the host at setup time (ruge_stuben/cf_splitting.cpp,
par_cf_splitting.cpp:60-163); the device consumes only the resulting
splitting vector. State constants follow core/types.hpp:29-35.
"""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import CFState


def _pattern(s: CSRMatrix):
    """(indptr, indices, col_ptr, col_indices) of the diag-stripped S."""
    return native.split_pattern(s.indptr, s.indices, s.n_rows, s.n_cols)


def set_initial_states(s: CSRMatrix, pattern) -> np.ndarray:
    """Rows with no off-diagonal strong connections get NoNeighbors
    (par_cf_splitting.cpp:165-183)."""
    states = np.full(s.n_rows, CFState.Unassigned, dtype=np.int64)
    states[np.diff(pattern[0]) == 0] = CFState.NoNeighbors
    return states


def split_rs(s: CSRMatrix, states, pattern):
    """split_rs (cf_splitting.cpp:300-341): both RS passes."""
    indptr, indices, col_ptr, col_indices = pattern
    weights = np.diff(col_ptr).astype(np.int64)
    native.rs_first_pass(indptr, indices, col_ptr, col_indices, weights,
                         states)
    native.rs_second_pass(s.indptr, s.indices, states)
    return states


def cljp_main_loop(s: CSRMatrix, states, rand_vals, pattern):
    """(cf_splitting.cpp:502-577)."""
    n = s.n_rows
    indptr, indices, col_ptr, col_indices = pattern
    weights = np.ascontiguousarray(rand_vals[:n], dtype=np.float64).copy()
    weights += np.bincount(indices, minlength=n)  # strong-graph in-degree
    native.cljp_main_loop(indptr, indices, col_ptr, col_indices, states,
                          weights)
    return states


def split_rs_entry(s: ParCSRMatrix):
    """split_rs parallel entry (par_cf_splitting.cpp:60-83): initial states
    then the serial RS pass over the global matrix."""
    s = s.global_csr
    pat = _pattern(s)
    return split_rs(s, set_initial_states(s, pat), pat)


def split_falgout(s: ParCSRMatrix, rand_vals):
    """RS everywhere, then CLJP on shard-boundary rows
    (par_cf_splitting.cpp:103-126); globally there are no boundary rows,
    so this is the reference's 1-rank behaviour."""
    s = s.global_csr
    pat = _pattern(s)
    states = split_rs(s, set_initial_states(s, pat), pat)
    return cljp_main_loop(s, states, rand_vals, pat)
