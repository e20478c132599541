"""Direct, modified-classical and extended+i interpolation (copy of
raptor_tpu.ruge_stuben.interpolation: the direct row algorithm, the native
host kernels, the row-sum-preserving filter, the dispatch between the host
and the device engines, and the ``par_interpolation`` partition rule).

Direct interpolation is the reference's serial row algorithm
(ruge_stuben/interpolation.cpp:443-597) over the global matrix. The native
kernels have the production (parallel) semantics of the reference's
par_interpolation.cpp (:301-1010 extended+i, :1012-1400 modified
classical). All run globally, so the result does not depend on the shard
count. Extended+i and modified classical also have device engines
(``device.interp``), which ``par_interpolation``'s ``engine`` selects:
"host", "device", or "auto" (the device engine for a level of at least
``DEVICE_MIN_NNZ`` nonzeros when the device is a CUDA card that is
present). A device engine's error propagates; only its width cap
(``InterpOverflow``) hands the level to the host kernel, and
``LAST_ENGINE`` records which engine ran and why.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import ZERO_TOL, CFState
from raptor_tpu_torch.device import interp as dinterp

S_, F = CFState.Selected, CFState.Unselected


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


def direct_interpolation(a: CSRMatrix, s: CSRMatrix,
                         states: np.ndarray) -> CSRMatrix:
    """interpolation.cpp:443-597. For each F row: P_ij = -(alpha|beta)*a_ij/d
    over strong coarse cols, alpha = (sum all neg off-diag)/(sum strong neg
    coarse), beta likewise for pos (if no strong pos, pos sum folds into the
    diagonal instead)."""
    n = a.n_rows
    col_to_new, n_coarse = _coarse_map(states)
    diag = a.diagonal()

    # the reference re-reads A's values on S's pattern: mark A's positions
    # that are strong
    strong_mask = native.mark_strong(a.indptr, a.indices, s.indptr,
                                     s.indices, a.n_rows).astype(bool)

    rows_all, cols_all, data_all = a.row_ids(), a.indices, a.data
    offd = rows_all != cols_all
    neg = data_all < 0

    def _rowsum(mask):
        return np.bincount(rows_all[mask], weights=data_all[mask],
                           minlength=n)

    sum_all_neg = _rowsum(offd & neg)
    sum_all_pos = _rowsum(offd & ~neg)

    s_coarse = strong_mask & offd & (states[cols_all] == S_)
    sum_strong_neg = _rowsum(s_coarse & neg)
    sum_strong_pos = _rowsum(s_coarse & ~neg)

    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = sum_all_neg / sum_strong_neg
    no_pos = sum_strong_pos == 0
    eff_diag = np.where(no_pos, diag + sum_all_pos, diag)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(no_pos, 0.0, sum_all_pos / sum_strong_pos)
    neg_coeff = -alpha / eff_diag
    pos_coeff = -beta / eff_diag

    # P entries: C rows get identity; F rows get coeff * a_ij at strong
    # coarse cols (row order preserved = ascending col)
    p_rows = rows_all[s_coarse]
    p_cols = cols_all[s_coarse]
    p_vals_raw = data_all[s_coarse]
    p_vals = np.where(p_vals_raw < 0, neg_coeff[p_rows] * p_vals_raw,
                      pos_coeff[p_rows] * p_vals_raw)
    f_rows_mask = states[p_rows] == F
    p_rows, p_cols, p_vals = (p_rows[f_rows_mask], p_cols[f_rows_mask],
                              p_vals[f_rows_mask])

    c_rows = np.nonzero(states == S_)[0]
    all_rows = np.concatenate([p_rows, c_rows])
    all_cols = np.concatenate([col_to_new[p_cols], col_to_new[c_rows]])
    all_vals = np.concatenate([p_vals, np.ones(len(c_rows))])

    # no duplicate (row, col) pairs: p entries come from distinct A
    # positions of F rows, c entries are identity rows of C points
    order = np.lexsort((all_cols, all_rows))
    indptr = np.concatenate(
        ([0], np.cumsum(np.bincount(all_rows, minlength=n),
                        dtype=np.int64)))
    return CSRMatrix(n, n_coarse, indptr, all_cols[order], all_vals[order])


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


# the level size (A's nonzeros) from which "auto" runs a device engine of
# the setup (interpolation here, the Galerkin product in
# ``multilevel.par_multilevel``): the JAX package's default, set there for
# a TPU
DEVICE_MIN_NNZ = 2_000_000


def auto_uses_device(level_nnz: int, device) -> bool:
    """Whether "auto" runs a device engine: a level of at least
    ``DEVICE_MIN_NNZ`` nonzeros and a CUDA card that is present (the JAX
    package's "auto" likewise stays on the host off its chip)."""
    return (level_nnz >= DEVICE_MIN_NNZ
            and torch.device(device).type == "cuda"
            and torch.cuda.is_available())


ENGINES = ("host", "device", "auto")

# the engine that the last extended+i or modified-classical dispatch ran
# ("host" or "device"), why it ran the host kernel when a device engine was
# asked for (its width cap; "" otherwise), and the count of device runs
LAST_ENGINE = {"interp": "host", "reason": "", "device_calls": 0}


def _device_interp_inputs(a: CSRMatrix, s: CSRMatrix, states):
    """The device engines' preamble: A's strong flags and the coarse
    map."""
    _, _, _, strong = _strong_flags(a, s)
    col_to_new, n_coarse = _coarse_map(states)
    return strong, col_to_new, n_coarse


def _use_device_interp(engine: str, level_nnz: int, device) -> bool:
    if engine not in ENGINES:
        raise ValueError(f"interpolation engine {engine!r}; one of "
                         f"{ENGINES}")
    return engine == "device" or (engine == "auto"
                                  and auto_uses_device(level_nnz, device))


def _record(engine: str, reason: str = "") -> None:
    LAST_ENGINE["interp"] = engine
    LAST_ENGINE["reason"] = reason
    LAST_ENGINE["device_calls"] += engine == "device"


def _device_dispatch(kind: str, a: CSRMatrix, s: CSRMatrix, states,
                     engine: str, level_nnz: int, device) -> CSRMatrix:
    """P of ``kind`` ("extended" or "mod_classical") by the selected
    engine. Unlike the JAX package's dispatch, no error of a device engine
    is caught: the host kernel runs only when the engine was not chosen or
    when its width cap (``InterpOverflow``) was hit."""
    reason = ""
    if _use_device_interp(engine, level_nnz, device):
        strong, col_to_new, n_coarse = _device_interp_inputs(a, s, states)
        run = (dinterp.extended_interp_device if kind == "extended"
               else dinterp.mod_classical_interp_device)
        try:
            p = run(a, strong, np.asarray(states), col_to_new, n_coarse,
                    device=device)
        except dinterp.InterpOverflow as e:
            reason = f"cap: {e}"
        else:
            _record("device")
            return p
    _record("host", reason)
    return _KINDS[kind](a, s, states)


_extended_dispatch = functools.partial(_device_dispatch, "extended")
_mod_classical_dispatch = functools.partial(_device_dispatch,
                                            "mod_classical")

_KINDS = {"direct": direct_interpolation,
          "mod_classical": mod_classical_interpolation,
          "extended": extended_interpolation}
_DISPATCH = {"mod_classical": _mod_classical_dispatch,
             "extended": _extended_dispatch}


def par_interpolation(a: ParCSRMatrix, s: ParCSRMatrix, states,
                      kind: str = "direct", engine: str = "host",
                      device="cuda") -> ParCSRMatrix:
    """P of the given ``kind`` ("direct", "mod_classical" or "extended")
    with the reference's partition: A's rows, and coarse columns owned
    where their fine C-points live. ``engine`` ("host", "device" or
    "auto") selects the engine of modified classical and extended+i;
    ``device`` is where a device engine runs."""
    if kind not in _KINDS:
        raise ValueError(f"interpolation kind {kind!r}; the port runs "
                         f"{sorted(_KINDS)}")
    if kind in _DISPATCH:
        p = _DISPATCH[kind](a.global_csr, s.global_csr, states, engine,
                            a.nnz, device)
    else:
        p = _KINDS[kind](a.global_csr, s.global_csr, states)
    row_bounds = a.partition.row_bounds
    csum = np.concatenate([[0], np.cumsum(np.asarray(states) == S_)])
    part = Partition(a.global_num_rows, p.n_cols, a.partition.n_shards,
                     row_bounds, csum[row_bounds].astype(np.int64))
    return ParCSRMatrix(p, part)
