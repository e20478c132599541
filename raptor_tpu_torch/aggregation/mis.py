"""MIS(2): the distance-2 maximal independent set that picks the roots of
smoothed aggregation (copy of raptor_tpu.aggregation.mis, native path;
aggregation/mis.cpp:8-220)."""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.types import CFState


def mis2(s: CSRMatrix, rand_vals: np.ndarray) -> np.ndarray:
    """CF states of the MIS(2) of S's pattern (diagonal included), ranked
    by ``rand_vals``: Selected (1) for a root, Unselected (0) otherwise."""
    m = s.to_scipy()
    m.sort_indices()
    n = s.n_rows
    r = np.asarray(rand_vals, dtype=np.float64)[:n]
    states = np.full(n, CFState.Unassigned, dtype=np.int64)
    csc = m.tocsc()
    csc.sort_indices()
    native.mis2(m.indptr, m.indices, csc.indptr, csc.indices, r, states)
    return states
