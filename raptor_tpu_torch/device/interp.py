"""Extended+i and modified-classical interpolation on the device (copy of
raptor_tpu.device.interp in torch ops).

The host kernels (``ruge_stuben.interpolation``, the production semantics
of the reference's par_interpolation.cpp:301-1010 and :1012-1400) walk a
distance-2 pattern row by row with a denominator per pair. The device
engine reduces extended+i to the expand / sort / merge steps of
``device.spgemm`` and two observations:

  * P's row pattern is strong-C(i) together with strong-C(k) over the
    strong-F neighbours k: one expand (strong-C rows gathered by strong-F
    columns) merged with strong-C(i).
  * Every strong-C column of such a k is in the pattern by construction,
    so the denominator D_ik = sum of the sign-ok a_kj over j in the
    pattern and i splits into dsc_k (a row constant), the few weak-C
    sign-ok entries of k (membership by a small broadcast compare against
    the merged pattern) and the a_ki term sampled on the host.

Each row chunk computes the pattern merge, D, the ratios a_ik / D_ik (a
tiny D folds a_ik into the weak sum and distributes nothing, as the
parallel reference does), the weak sums (with the "+i" fold-back and the
in-pattern weak-C correction), the contributions masked to the pattern, a
final merge and the scaling by -1 / weak sum. Modified classical needs no
expand: its pattern is the strong-C slab, and only the values are computed
on the device.

The host operands come from one native pass (``native.interp_dev_prep``
and ``interp_dev_prep_mc``); ``_prep_numpy`` is that pass in numpy, the
oracle the tests hold it to. The default precision is float64.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.types import ZERO_TOL, CFState
from raptor_tpu_torch.device.par import resolve_device
from raptor_tpu_torch.device.spgemm import (
    SENT, _merge_compact, np_dtype, upload)

S_, F = CFState.Selected, CFState.Unselected

# per-chunk candidate-slab byte budget (cols + vals each)
_SLAB_BYTES = 192 * 1024 * 1024


class InterpOverflow(Exception):
    """A pattern outgrew the device engine's width cap; the caller
    computes P with the host kernel."""


# --- host packing -------------------------------------------------------------

def _ell_from_subset(n: int, rows: np.ndarray, cols: np.ndarray,
                     vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[W, n] ELL (slot major, float64 values) of a subset of entries in
    CSR order."""
    cnt = np.bincount(rows, minlength=n)
    W = max(1, int(cnt.max()) if len(rows) else 1)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=starts[1:])
    pos = np.arange(len(rows), dtype=np.int64) - starts[rows]
    c = np.full((W, n), SENT, dtype=np.int32)
    v = np.zeros((W, n))
    c[pos, rows] = cols
    v[pos, rows] = vals
    return c, v


def _prep(a: CSRMatrix, strong: np.ndarray, states: np.ndarray):
    """Every host operand of the extended+i engine, by the native pass
    (float64 values; ``_prep_numpy``'s contract)."""
    indptr, indices, data = a.sorted_csr()
    return native.interp_dev_prep(indptr, indices, data,
                                  np.asarray(strong), states)


def _prep_numpy(a: CSRMatrix, strong: np.ndarray, states: np.ndarray):
    """``_prep`` in numpy: the oracle of the native pass."""
    n = a.n_rows
    indptr, indices, data = a.sorted_csr()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    strongb = strong.astype(bool)
    offd = indices != rows
    st_col = states[indices]
    cstate = st_col == S_
    fstate = st_col == F
    f_row = states[rows] == F

    diag = np.zeros(n)
    dmask = ~offd
    diag[rows[dmask]] = data[dmask]
    sgn = np.where(diag < 0, -1.0, 1.0)
    sign_ok = data * sgn[rows] < 0

    def pack(mask):
        m = mask & f_row
        return _ell_from_subset(n, rows[m], indices[m], data[m])

    sc_c, sc_v = pack(strongb & cstate)            # strong C entries
    sf_m = strongb & fstate & f_row                # strong F entries
    sf_rows, sf_cols, sf_vals = rows[sf_m], indices[sf_m], data[sf_m]
    sf_c, sf_v = _ell_from_subset(n, sf_rows, sf_cols, sf_vals)
    bcs_m = sign_ok & cstate & strongb & f_row     # -> dsc row sums
    bcw_c, bcw_v = pack(sign_ok & cstate & ~strongb)
    awc_c, awc_v = pack(~strongb & cstate & offd)

    dsc = np.bincount(rows[bcs_m], weights=data[bcs_m], minlength=n)
    # the sign-ok strong-C rows, gathered by strong-F columns in the
    # contribution expand
    bcs_c, bcs_v = pack(bcs_m)

    # weak-sum base: the diagonal and every non-strong off-diagonal entry
    # of an F row toward a column with neighbours (NoNeighbors stays out,
    # par_interpolation.cpp:831-838); the in-pattern weak-C part is taken
    # off on the device
    wm = ~strongb & offd & f_row & (st_col != CFState.NoNeighbors)
    wsum0 = diag + np.bincount(rows[wm], weights=data[wm], minlength=n)

    # a_ki for each strong-F pair (k = the pair's column, i = its row):
    # with sorted rows and sorted columns in each row, row * n + col is a
    # sorted key, so one searchsorted finds every pair
    key = rows * n + indices
    want = sf_cols * n + sf_rows
    loc = np.searchsorted(key, want)
    loc_c = np.minimum(loc, len(key) - 1)
    hit = (len(key) > 0) & (key[loc_c] == want)
    a_ki = np.where(hit, data[loc_c], 0.0)
    di = np.where(a_ki * sgn[sf_cols] < 0, a_ki, 0.0)   # D's i term
    _, di_v = _ell_from_subset(n, sf_rows, sf_cols, di)
    _, at_v = _ell_from_subset(n, sf_rows, sf_cols, a_ki)

    # the exact bound of a pattern row, |SC_i| + sum over k in SF_i of
    # |SC_k|, at least 1 as the native pass gives it
    sc_cnt = np.bincount(rows[strongb & cstate], minlength=n)
    bound = np.bincount(rows[strongb & cstate & f_row], minlength=n)
    np.add.at(bound, sf_rows, sc_cnt[sf_cols])
    return dict(sc=(sc_c, sc_v), sf=(sf_c, sf_v), di_v=di_v, at_v=at_v,
                bcs=(bcs_c, bcs_v), bcw=(bcw_c, bcw_v),
                awc=(awc_c, awc_v), dsc=dsc, wsum0=wsum0,
                p_bound=max(1, int(bound.max()) if n else 1))


def _where0(mask, x):
    return torch.where(mask, x, 0.0)


def _sent(mask, c):
    return torch.where(mask, c, int(SENT))


# --- the device engine --------------------------------------------------------

def _interp_chunk(sc_c, sc_v, sf_c, sf_v, di_v, awc_c, awc_v,
                  wsum0, scg_c, bcs_c, bcs_v, bcw_c, bcw_v, dsc,
                  p_cap: int, ztol: float):
    """One row chunk of extended+i with the production (parallel)
    semantics (par_interpolation.cpp:719-841). The chunk's own slabs are
    [W, C]; the gather sources (scg, bcs, bcw, dsc) are the whole
    operands."""
    W_SF, C = sf_c.shape
    active = sf_c != int(SENT)
    safe = torch.where(active, sf_c, torch.zeros_like(sf_c)).long()

    # 1. the pattern: SC(i) and SC(k) over strong-F k, distance-2 entries
    # at 0
    gp = scg_c[:, safe]                                  # [W_SC, W_SF, C]
    gpv = active[None] & (gp != int(SENT))
    cand_c = torch.cat([sc_c, _sent(gpv, gp).reshape(-1, C)])
    cand_v = torch.cat([sc_v, sc_v.new_zeros((gp.shape[0] * W_SF, C))])
    p0c, p0v, _, mx = _merge_compact(cand_c, cand_v, p_cap, -1.0)

    # 2. denominators D_ik = dsc_k + the weak-C entries in the pattern
    # + [a_ki sign-ok]
    bw = bcw_c[:, safe]                                  # [W_BCW, W_SF, C]
    bwv = bcw_v[:, safe]
    mem_w = ((bw[None] == p0c[:, None, None, :]).any(0)
             & (bw != int(SENT)) & active[None])
    d = dsc[safe] * active + di_v + _where0(mem_w, bwv).sum(0)

    # 3. ratios and weak sums. A tiny D folds a_ik into the weak sum and
    # distributes nothing (r = 0, the parallel reference's else branch,
    # :781-786); the +i term is the sign-filtered di_v (:797-801)
    tiny = d.abs() < ztol
    r = torch.where(tiny, torch.zeros_like(d),
                    sf_v / torch.where(tiny, torch.ones_like(d), d)) * active
    aw_m = (awc_c[None] == p0c[:, None, :]).any(0) & (awc_c != int(SENT))
    weak = (wsum0
            + _where0(tiny & active, sf_v).sum(0)
            + (r * di_v).sum(0)
            - _where0(aw_m, awc_v).sum(0))

    # 4. contributions r_ik a_kj: strong-C(k) needs no mask (always in the
    # pattern), weak-C(k) is masked by mem_w; and the row's own weak
    # entries whose column is in the pattern fold into P (:727-732); all
    # merge into the pattern
    bs = bcs_c[:, safe]                                  # [W_BCS, W_SF, C]
    bsv = bcs_v[:, safe]
    bs_ok = (bs != int(SENT)) & active[None]
    fc = torch.cat([p0c, _sent(bs_ok, bs).reshape(-1, C),
                    _sent(mem_w, bw).reshape(-1, C), _sent(aw_m, awc_c)])
    fv = torch.cat([p0v, _where0(bs_ok, r[None] * bsv).reshape(-1, C),
                    _where0(mem_w, r[None] * bwv).reshape(-1, C),
                    _where0(aw_m, awc_v)])
    pc, pv, counts, _ = _merge_compact(fc, fv, p_cap, -1.0)
    ok = weak.abs() > ztol
    pv = torch.where(ok[None, :],
                     pv / torch.where(ok, -weak, torch.ones_like(weak))[None],
                     pv)
    return pc, pv, counts, mx


def _mc_chunk(sc_c, sc_v, sf_c, sf_v, wsum0, sgn_all, bag_c, bag_v,
              ztol: float):
    """One row chunk of modified classical with the production (parallel)
    semantics (par_interpolation.cpp:1255-1330): the pattern is the
    strong-C slab; each strong-F neighbour k spreads its value over the
    C-state entries of its row that are in the pattern and whose sign is
    opposite to k's own diagonal (gathered from ``sgn_all``); a tiny
    coarse sum folds a_ik into the weak sum and still distributes its raw
    value (:1292); there is no +i term."""
    active = sf_c != int(SENT)
    safe = torch.where(active, sf_c, torch.zeros_like(sf_c)).long()
    ba = bag_c[:, safe]                                  # [W_BA, W_SF, C]
    bav = bag_v[:, safe]
    sgnk = sgn_all[safe]                                 # [W_SF, C]
    sok = (bav * sgnk[None] < 0) & (ba != int(SENT)) & active[None]
    mem = ba[None] == sc_c[:, None, None, :]     # [W_SC, W_BA, W_SF, C]
    hit = mem.any(0) & sok                               # [W_BA, W_SF, C]
    d = _where0(hit, bav).sum(0)                         # [W_SF, C]
    tiny = d.abs() < ztol
    ratio = torch.where(tiny, d,
                        sf_v / torch.where(tiny, torch.ones_like(d), d)
                        ) * active
    weak = wsum0 + _where0(tiny & active, sf_v).sum(0)
    contrib = _where0(mem & hit[None], (ratio[None] * bav)[None]
                      ).sum(dim=(1, 2))
    return (sc_v + contrib) / (-weak)[None, :]


def _chunk(n: int, w_slot: int) -> Tuple[int, int]:
    """(rows per chunk, padded rows): the widest slab of a chunk under
    the budget, a multiple of 512."""
    C = max(512, _SLAB_BYTES // max(w_slot * 8, 1))
    C = min(-(-C // 512) * 512, -(-n // 512) * 512)
    return C, -(-n // C) * C


def _padded(x: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    pad = ((0, 0),) * (x.ndim - 1) + ((0, n_pad - x.shape[-1]),)
    return np.pad(x, pad, constant_values=fill)


def mod_classical_interp_device(a: CSRMatrix, strong: np.ndarray,
                                states: np.ndarray,
                                col_to_new: np.ndarray, n_coarse: int,
                                variables=None, num_variables: int = 1,
                                dtype=None, device="cuda") -> CSRMatrix:
    """Modified-classical P with its distribution work on ``device``. The
    pattern and its counts are the strong-C slab's; only the values are
    computed there."""
    device = resolve_device(device)
    dtype = np_dtype(dtype)
    n = a.n_rows
    states = np.asarray(states)
    indptr, indices, data = a.sorted_csr()
    ops = native.interp_dev_prep_mc(indptr, indices, data,
                                    np.asarray(strong), states,
                                    variables, num_variables)
    sc_c, sc_v = ops["sc"]
    sf_c, sf_v = ops["sf"]
    ba_c, ba_v = ops["ba"]
    W_SC, W_SF, W_BA = sc_c.shape[0], sf_c.shape[0], ba_c.shape[0]
    # the membership compare dominates: W_SC W_BA W_SF booleans a row
    C, n_pad = _chunk(n, max(1, W_SC * W_BA * W_SF // 8))

    def up(x, fill=0):
        return upload(_padded(x, n_pad, fill), device)

    bag_c, bag_v = up(ba_c, SENT), up(ba_v.astype(dtype))
    sc_cd, sc_vd = up(sc_c, SENT), up(sc_v.astype(dtype))
    sf_cd, sf_vd = up(sf_c, SENT), up(sf_v.astype(dtype))
    wsum0d = up(ops["wsum0"].astype(dtype))
    sgnd = up(ops["sgn"].astype(dtype))
    outs = [_mc_chunk(sc_cd[:, s:s + C], sc_vd[:, s:s + C],
                      sf_cd[:, s:s + C], sf_vd[:, s:s + C],
                      wsum0d[s:s + C], sgnd, bag_c, bag_v,
                      ztol=float(ZERO_TOL))
            for s in range(0, n_pad, C)]
    vals = torch.cat(outs, dim=1).cpu().numpy()[:, :n]
    counts = (sc_c != SENT).sum(axis=0)
    return _assemble_p(n, n_coarse, states, sc_c, vals, counts, col_to_new)


def _assemble_p(n, n_coarse, states, cols, vals, counts, col_to_new
                ) -> CSRMatrix:
    """[W, n] device output and per-row counts as a CSR with identity C
    rows (both device interpolations)."""
    c_rows = states == S_
    f_counts = np.where(c_rows, 0, counts)
    row_counts = np.where(c_rows, 1, f_counts)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_counts, out=indptr[1:])
    nnz = int(indptr[-1])
    colsT, valsT = cols.T, vals.T
    mask = np.arange(colsT.shape[1])[None, :] < f_counts[:, None]
    out_c = np.empty(nnz, dtype=np.int64)
    out_v = np.empty(nnz)
    c_pos = indptr[:-1][c_rows]
    sel = np.ones(nnz, dtype=bool)
    sel[c_pos] = False
    out_c[sel] = col_to_new[colsT[mask].astype(np.int64)]
    out_v[sel] = valsT[mask]
    out_c[c_pos] = col_to_new[np.flatnonzero(c_rows)]
    out_v[c_pos] = 1.0
    return CSRMatrix(n, n_coarse, indptr, out_c, out_v)


def extended_interp_device(a: CSRMatrix, strong: np.ndarray,
                           states: np.ndarray, col_to_new: np.ndarray,
                           n_coarse: int, dtype=None,
                           device="cuda") -> CSRMatrix:
    """Extended+i P with its distance-2 work on ``device``. ``strong`` is
    the int8 or bool flag of each of A's entries (in A's sorted order).
    Single-variable systems only, as the port's host kernel."""
    device = resolve_device(device)
    dtype = np_dtype(dtype)
    n = a.n_rows
    states = np.asarray(states)
    ops = _prep(a, np.asarray(strong), states)
    sc_c, sc_v = ops["sc"]
    sf_c, sf_v = ops["sf"]
    bcs_c, bcs_v = ops["bcs"]
    bcw_c, bcw_v = ops["bcw"]
    awc_c, awc_v = ops["awc"]
    W_SC, W_SF = sc_c.shape[0], sf_c.shape[0]
    W_BCS, W_BCW, W_AWC = bcs_c.shape[0], bcw_c.shape[0], awc_c.shape[0]
    p_cap = max(8, min(ops["p_bound"], n_coarse))

    # the widest slab of a chunk: the pattern expand, the final merge, or
    # the boolean membership compares (a boolean counted at 1/8 of the
    # 8-byte slot)
    w_slot = max(W_SC * (1 + W_SF),
                 p_cap + W_SF * (W_BCS + W_BCW),
                 p_cap * (W_BCW * W_SF + W_AWC) // 8)
    C, n_pad = _chunk(n, w_slot)

    def up(x, fill=0):
        return upload(_padded(x, n_pad, fill), device)

    # every operand goes up once and is sliced on the device per chunk
    scg_d = up(sc_c, SENT)
    bcs_cd, bcs_vd = up(bcs_c, SENT), up(bcs_v.astype(dtype))
    bcw_cd, bcw_vd = up(bcw_c, SENT), up(bcw_v.astype(dtype))
    dsc_d = up(ops["dsc"].astype(dtype))
    sc_vd = up(sc_v.astype(dtype))
    sf_cd, sf_vd = up(sf_c, SENT), up(sf_v.astype(dtype))
    di_vd = up(ops["di_v"].astype(dtype))
    awc_cd, awc_vd = up(awc_c, SENT), up(awc_v.astype(dtype))
    wsum0d = up(ops["wsum0"].astype(dtype))

    # every chunk is enqueued before the one readback
    outs = []
    for s in range(0, n_pad, C):
        sl = np.s_[:, s:s + C]
        outs.append(_interp_chunk(
            scg_d[sl], sc_vd[sl], sf_cd[sl], sf_vd[sl], di_vd[sl],
            awc_cd[sl], awc_vd[sl], wsum0d[s:s + C],
            scg_d, bcs_cd, bcs_vd, bcw_cd, bcw_vd, dsc_d,
            p_cap=p_cap, ztol=float(ZERO_TOL)))
    mx = int(torch.stack([m for *_, m in outs]).max())
    if mx > p_cap:
        raise InterpOverflow(f"pattern width {mx} > cap {p_cap}")
    counts = torch.cat([cnt for _, _, cnt, _ in outs]).cpu().numpy()[:n]
    cols = torch.cat([pc for pc, *_ in outs], dim=1).cpu().numpy()[:, :n]
    vals = torch.cat([pv for _, pv, *_ in outs], dim=1).cpu().numpy()[:, :n]
    return _assemble_p(n, n_coarse, states, cols, vals, counts, col_to_new)
