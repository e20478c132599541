"""CF splitting: Ruge-Stuben, CLJP, Falgout, PMIS and HMIS (copy of
raptor_tpu.ruge_stuben.cf_splitting, native paths only).

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


def split_rs(s: CSRMatrix, states, pattern, second_pass: bool = True):
    """split_rs (cf_splitting.cpp:300-341): the RS first pass, then the
    second pass unless HMIS asks for the first alone."""
    indptr, indices, col_ptr, col_indices = pattern
    weights = np.diff(col_ptr).astype(np.int64)
    native.rs_first_pass(indptr, indices, col_ptr, col_indices, weights,
                         states)
    if second_pass:
        native.rs_second_pass(s.indptr, s.indices, states)
    return states


def _initial_weights(rand_vals, indices, n):
    """Random weights plus the strong-graph in-degree (CLJP and PMIS)."""
    weights = np.ascontiguousarray(rand_vals[:n], dtype=np.float64).copy()
    weights += np.bincount(indices, minlength=n)
    return weights


def cljp_main_loop(s: CSRMatrix, states, rand_vals, pattern):
    """(cf_splitting.cpp:502-577)."""
    indptr, indices, col_ptr, col_indices = pattern
    weights = _initial_weights(rand_vals, indices, s.n_rows)
    native.cljp_main_loop(indptr, indices, col_ptr, col_indices, states,
                          weights)
    return states


def pmis_main_loop(s: CSRMatrix, states, rand_vals, pattern):
    """(cf_splitting.cpp:578-665)."""
    indptr, indices, col_ptr, col_indices = pattern
    weights = _initial_weights(rand_vals, indices, s.n_rows)
    native.pmis_main_loop(indptr, indices, col_ptr, col_indices, states,
                          weights)
    return states


def split_rs_entry(s: ParCSRMatrix):
    """split_rs parallel entry (par_cf_splitting.cpp:60-83): initial states
    then the serial RS pass over the global matrix."""
    s = s.global_csr
    pat = _pattern(s)
    return split_rs(s, set_initial_states(s, pat), pat)


def split_cljp(s: ParCSRMatrix, rand_vals):
    """CLJP: initial states, then the CLJP loop (cf_splitting.cpp:502-577)
    over the global matrix."""
    s = s.global_csr
    pat = _pattern(s)
    return cljp_main_loop(s, set_initial_states(s, pat), rand_vals, pat)


def split_falgout(s: ParCSRMatrix, rand_vals):
    """RS everywhere, then CLJP on shard-boundary rows
    (par_cf_splitting.cpp:103-126); globally there are no boundary rows,
    so this is the reference's 1-rank behaviour."""
    s = s.global_csr
    pat = _pattern(s)
    states = split_rs(s, set_initial_states(s, pat), pat)
    return cljp_main_loop(s, states, rand_vals, pat)


def split_pmis(s: ParCSRMatrix, rand_vals):
    """PMIS: initial states, then the independent-set loop over the
    global matrix."""
    s = s.global_csr
    pat = _pattern(s)
    return pmis_main_loop(s, set_initial_states(s, pat), rand_vals, pat)


def split_hmis(s: ParCSRMatrix, rand_vals):
    """HMIS (par_cf_splitting.cpp:142-163): the RS first pass, then PMIS on
    what it left unassigned."""
    s = s.global_csr
    pat = _pattern(s)
    states = split_rs(s, set_initial_states(s, pat), pat, second_pass=False)
    return pmis_main_loop(s, states, rand_vals, pat)
