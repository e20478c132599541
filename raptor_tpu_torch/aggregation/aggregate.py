"""Aggregation of nodes around the MIS(2) roots (copy of
raptor_tpu.aggregation.aggregate, native path; aggregation/aggregate.cpp:
6-95)."""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix


def aggregate(a: CSRMatrix, s: CSRMatrix, states: np.ndarray,
              rand_vals: np.ndarray = None):
    """(n_aggs, aggregates[i] in [0, n_aggs)). Each root starts an
    aggregate; a node joins its first strongly connected root's, and a
    node with none joins the aggregate of the neighbour with the largest
    |a_ij| + rand_vals[j]. Without ``rand_vals`` (the production solver)
    the tie-break weights are zero."""
    n = s.n_rows
    r = (np.asarray(rand_vals, dtype=np.float64)[:n] if rand_vals is not None
         else np.zeros(n))
    sm = s.to_scipy()
    am = a.to_scipy()
    sm.sort_indices(), am.sort_indices()
    aggregates = np.full(n, -1, dtype=np.int64)
    n_aggs = native.aggregate(sm.indptr, sm.indices, am.indptr, am.indices,
                              am.data, states, r, aggregates)
    return n_aggs, aggregates
