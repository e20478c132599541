"""Device sparse formats: NumPy packers and their plain PyTorch SpMVs
(copy of raptor_tpu.device.formats for the ELL, DIA, BDIA, windowed-ELL,
sorted-scatter transpose and BELL formats).

Every function that takes tensors works on STACKED shards: a leading axis
``S`` over the partition's shards, so one call does what the JAX package
runs once per shard under ``shard_map``. Index tensors are int64 (torch's
gather/scatter index type); BDIA lane ids stay int8, as the kernel reads
them. Padding entries point at column 0 with value 0, so the linear ops
need no masks.

``dia_spmv``, ``bdia_spmv``, ``wind_ell_spmv``, ``swellt_spmv_T`` and
``bell_spmv`` are the plain versions of the hand-written CUDA kernels in
``raptor_tpu_torch/csrc``; ``device.kernels`` launches the kernels on CUDA
tensors and calls these on CPU tensors only. ``bdia_tiles`` lists the
non-empty BDIA tiles, which the BDIA kernel walks in place of every plane;
``bell_counts`` and ``swellt_counts`` count the real slots of a BELL row
block and the real entries of a sorted-scatter slot, past which the BELL
and sorted-scatter kernels read nothing. All three read the packed arrays
and add nothing to them. The packers are the JAX
package's, byte for byte, TPU tiling constants included (the windowed-ELL
tile of ``ba * 128`` rows and 8-aligned window starts, the swellt output
window of ``SWELLT_AMAX`` rows): they fix the layout, which the CUDA
kernels read as it is.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from raptor_tpu_torch.core.matrix import CSRMatrix

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather: ``out[s, ...] = x[s, idx[s, ...]]``."""
    S = x.shape[0]
    return torch.gather(x, 1, idx.reshape(S, -1)).reshape(idx.shape)


def _scatter_add(n_out: int, idx: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """Per-shard scatter-add into zeros ``[S, n_out]``; indices equal to
    ``n_out`` (the packers' out-of-bounds row pad) are dropped."""
    S = src.shape[0]
    out = torch.zeros((S, n_out + 1), dtype=src.dtype, device=src.device)
    out.scatter_add_(1, idx.reshape(S, -1), src.reshape(S, -1))
    return out[:, :n_out]


# --- transposed ELL -------------------------------------------------------------

def ell_arrays(a: CSRMatrix, rows_pad: int, width: int = None,
               dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a CSR block into transposed-ELL [W, rows_pad] cols/vals."""
    row_nnz = np.diff(a.indptr)
    w = int(row_nnz.max()) if a.nnz else 0
    if width is None:
        width = max(1, w)
    assert w <= width, f"row width {w} exceeds requested {width}"
    rows_pad = max(rows_pad, a.n_rows, 1)
    cols = np.zeros((width, rows_pad), dtype=np.int32)
    vals = np.zeros((width, rows_pad), dtype=dtype)
    if a.nnz:
        rows = np.repeat(np.arange(a.n_rows), row_nnz)
        pos = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
        cols[pos, rows] = a.indices
        vals[pos, rows] = a.data
    return cols, vals


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """b[s, r] = sum_w vals[s, w, r] * x[s, cols[s, w, r]]."""
    return (vals * _take(x, cols)).sum(dim=1)


def ell_spmv_T(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
               n_out: int) -> torch.Tensor:
    """b = A^T x for an ELL block: scatter-add vals[s,w,r]*x[s,r] at
    cols[s,w,r]; padding adds 0 at column 0."""
    return _scatter_add(n_out, cols, vals * x[:, None, :vals.shape[2]])


# --- boundary-compacted off_proc block --------------------------------------------

def ell_boundary_arrays(a: CSRMatrix, width: int, b_pad: int,
                        rows_pad: int, dtype=np.float64):
    """Pack a CSR block into boundary-compacted ELL: (rows [b_pad] int32,
    cols [width, b_pad] int32, vals [width, b_pad]) over the rows that hold
    entries. Row padding slots hold ``rows_pad`` (dropped by the scatter)."""
    row_nnz = np.diff(a.indptr)
    brows = np.nonzero(row_nnz)[0]
    rows = np.full(b_pad, rows_pad, dtype=np.int32)
    cols = np.zeros((width, b_pad), dtype=np.int32)
    vals = np.zeros((width, b_pad), dtype=dtype)
    if len(brows):
        rows[:len(brows)] = brows
        bn = row_nnz[brows]
        rpos = np.repeat(np.arange(len(brows)), bn)
        pos = np.arange(a.nnz) - np.repeat(a.indptr[brows], bn)
        cols[pos, rpos] = a.indices
        vals[pos, rpos] = a.data
    return rows, cols, vals


def off_spmv(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             halo: torch.Tensor, n_rows: int) -> torch.Tensor:
    """b = A_off @ halo over the boundary rows; a full [S, n_rows] result
    (zeros elsewhere)."""
    if cols.numel() == 0:
        return torch.zeros((halo.shape[0], n_rows), dtype=halo.dtype,
                           device=halo.device)
    contrib = (vals * _take(halo, cols)).sum(dim=1)        # [S, B]
    return _scatter_add(n_rows, rows, contrib)


def off_spmv_T(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor, n_out: int) -> torch.Tensor:
    """halo_contrib = A_off^T x: gather x at the boundary rows, scatter-add
    at the halo cols. Row pads read the last row with value 0."""
    if cols.numel() == 0:
        return torch.zeros((x.shape[0], n_out), dtype=x.dtype,
                           device=x.device)
    xb = _take(x, rows.clamp(max=x.shape[1] - 1))          # [S, B]
    return _scatter_add(n_out, cols, vals * xb[:, None, :])


# --- DIA (diagonal) format --------------------------------------------------------

def dia_detect(a: CSRMatrix, max_offsets: int) -> np.ndarray:
    """Distinct col-row offsets, or None if the block is not DIA-friendly."""
    if a.nnz == 0:
        return np.zeros(0, dtype=np.int64)
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    offs = np.unique(a.indices - rows)
    if len(offs) > max_offsets:
        return None
    return offs


def dia_arrays(a: CSRMatrix, offsets: np.ndarray,
               rows_pad: int, dtype=np.float64) -> np.ndarray:
    """Pack CSR into DIA vals [K, rows_pad] against the offset set:
    vals[k, i] = A[i, i + offsets[k]] (0 where absent)."""
    K = len(offsets)
    vals = np.zeros((K, rows_pad), dtype=dtype)
    if a.nnz:
        rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
        entry_offs = a.indices - rows
        k_of = np.searchsorted(offsets, entry_offs)
        vals[k_of, rows] = a.data
    return vals


def dia_spmv(offsets: Tuple[int, ...], vals: torch.Tensor, x: torch.Tensor,
             pad: int) -> torch.Tensor:
    """b[s, i] = sum_k vals[s, k, i] * x[s, i + offsets[k]], with x zero
    outside [0, C): K shifted multiply-adds over a zero-padded x."""
    R = vals.shape[2]
    x_pad = F.pad(x, (pad, pad + max(0, R - x.shape[1])))
    b = torch.zeros((x.shape[0], R), dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        b = b + vals[:, k] * x_pad[:, off + pad:off + pad + R]
    return b


def dia_spmv_T(offsets: Tuple[int, ...], vals: torch.Tensor,
               x: torch.Tensor, n_out: int, pad: int) -> torch.Tensor:
    """b[s, i + offsets[k]] += vals[s, k, i] * x[s, i]: shifted
    accumulation into a zero-padded buffer."""
    R = vals.shape[2]
    width = 2 * pad + max(R, n_out)
    buf = torch.zeros((x.shape[0], width), dtype=x.dtype, device=x.device)
    for k, off in enumerate(offsets):
        buf[:, off + pad:off + pad + R] += vals[:, k] * x[:, :R]
    return buf[:, pad:pad + n_out]


# --- BDIA (block-diagonal + lane gather) format ---------------------------------
#
# An entry (r, c) lives in plane (d, slot) with d = c//128 - r//128 and
# stores only its lane c % 128; SpMV is, per plane, a shift of x viewed
# [C128, 128] by d blocks and a gather inside each 128-block.

def _bdia_d_slot(a: CSRMatrix):
    """Per-entry (d, slot) in CSR order: d = block offset, slot = occurrence
    index among a row's entries sharing d (consecutive in sorted CSR)."""
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    d = a.indices // LANE - rows // LANE
    r128 = max(1, (a.n_rows + LANE - 1) // LANE)
    c128 = max(1, (a.n_cols + LANE - 1) // LANE)
    key = rows * np.int64(r128 + c128 + 3) + (d + r128)
    new = np.concatenate(([True], key[1:] != key[:-1]))
    run_id = np.cumsum(new) - 1
    run_start = np.nonzero(new)[0]
    slot = np.arange(len(key)) - run_start[run_id]
    return rows, d, slot


def bdia_plane_counts(a: CSRMatrix):
    """All (d, slot) planes of a matrix with their entry counts:
    (planes [(d, slot), ...], counts)."""
    if a.nnz == 0:
        return [], np.zeros(0, dtype=np.int64)
    _, d, slot = _bdia_d_slot(a)
    span = np.int64(slot.max() + 2)
    key = d.astype(np.int64) * span + slot
    uniq, counts = np.unique(key, return_counts=True)
    dq = np.floor_divide(uniq, span)
    planes = [(int(dv), int(s)) for dv, s in zip(dq, uniq - dq * span)]
    return planes, counts


def select_planes(all_counts: dict, max_planes: int, a128: int):
    """Keep planes worth a streaming pass: count >= 0.15% of the plane's
    capacity, ranked by count, capped; (d, s) only with (d, s-1).
    Returns the kept planes sorted by (d, slot)."""
    cap = max(1.0, 0.0015 * a128 * LANE)
    ranked = sorted(all_counts.items(), key=lambda kv: -kv[1])
    kept = set()
    for (dv, s), cnt in ranked:
        if len(kept) >= max_planes:
            break
        if cnt < cap:
            break
        kept.add((dv, s))
    changed = True
    while changed:
        changed = False
        for (dv, s) in list(kept):
            if s > 0 and (dv, s - 1) not in kept:
                kept.discard((dv, s))
                changed = True
    return sorted(kept)


def bdia_split_rest(a: CSRMatrix, kept) -> CSRMatrix:
    """CSR of the entries NOT covered by the kept planes (the 'rest')."""
    if a.nnz == 0:
        return CSRMatrix.empty(a.n_rows, a.n_cols)
    _, d, slot = _bdia_d_slot(a)
    span = np.int64(max((s for _, s in kept), default=0) + 2 + slot.max())
    kk = np.array(sorted(dv * span + s for dv, s in set(kept)),
                  dtype=np.int64)
    ek = d.astype(np.int64) * span + slot
    if len(kk):
        pos = np.clip(np.searchsorted(kk, ek), 0, len(kk) - 1)
        in_plane = kk[pos] == ek
    else:
        in_plane = np.zeros(len(ek), dtype=bool)
    return a.filter_entries(~in_plane)


def bdia_arrays(a: CSRMatrix, plane_spec, a_pad: int,
                dtype=np.float64):
    """Pack CSR into BDIA planes: (idx [P, a_pad, 128] int8 lane ids,
    vals [P, a_pad, 128]); entries outside the spec are skipped (they
    live in the 'rest', see bdia_split_rest)."""
    P = len(plane_spec)
    idx = np.zeros((P, a_pad, LANE), dtype=np.int8)
    vals = np.zeros((P, a_pad, LANE), dtype=dtype)
    if a.nnz == 0 or P == 0:
        return idx, vals
    rows, d, slot = _bdia_d_slot(a)
    span = np.int64(max(s for _, s in plane_spec) + 2 + int(slot.max()))
    plane_keys = np.array([dv * span + s for dv, s in plane_spec],
                          dtype=np.int64)
    order = np.argsort(plane_keys)
    skeys = plane_keys[order]
    entry_keys = d.astype(np.int64) * span + slot
    pos = np.clip(np.searchsorted(skeys, entry_keys), 0, len(skeys) - 1)
    in_spec = skeys[pos] == entry_keys
    rows, pos = rows[in_spec], pos[in_spec]
    p_ids = order[pos]
    idx[p_ids, rows // LANE, rows % LANE] = a.indices[in_spec] % LANE
    vals[p_ids, rows // LANE, rows % LANE] = a.data[in_spec]
    return idx, vals


def bdia_tiles(vals: np.ndarray, rows_pad: int):
    """The non-empty (plane, 128-row block) tiles of packed BDIA planes
    ``vals [S, P, A_pad, 128]``, over the ``ceil(rows_pad / 128)`` row
    blocks the SpMV writes: a CSR per shard, ``tptr [S, nblk + 1]`` int32
    and ``tplane [S, Tmax]`` int32, where ``tplane[s, tptr[s, a]:tptr[s,
    a + 1]]`` are the planes p, increasing, whose tile ``vals[s, p, a, :]``
    holds a nonzero. ``Tmax`` is the largest shard's tile count, at least
    1; the padding entries are plane 0 and never read. Summing the listed
    tiles only gives ``bdia_spmv``'s result: a tile left out adds 0 * x."""
    S, P, _, _ = vals.shape
    nblk = -(-rows_pad // LANE)
    occ = np.zeros((S, nblk, P), dtype=bool)
    for p in range(P):      # one plane at a time: no full-size bool copy
        occ[:, :, p] = (vals[:, p, :nblk] != 0).any(axis=2)
    tptr = np.zeros((S, nblk + 1), dtype=np.int32)
    tptr[:, 1:] = np.cumsum(occ.sum(axis=2), axis=1)
    tplane = np.zeros((S, max(1, int(tptr[:, -1].max()))), dtype=np.int32)
    for s in range(S):
        tplane[s, :tptr[s, -1]] = np.nonzero(occ[s])[1]
    return tptr, tplane


def bdia_spmv(d_offsets: Tuple[int, ...], idx: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, padb: int,
              rows_pad: int) -> torch.Tensor:
    """out[s, a, l] = sum_p vals[s,p,a,l] * X[s, a + d_p, idx[s,p,a,l]],
    X = x viewed [C128, 128], zero outside; returns [S, rows_pad]."""
    S, P, A_pad, _ = idx.shape
    C = x.shape[1]
    C128 = -(-C // LANE)
    x2 = F.pad(x, (0, C128 * LANE - C)).reshape(S, C128, LANE)
    S_pad = max(A_pad, C128) + 2 * padb
    xp = F.pad(x2, (0, 0, padb, S_pad - C128 - padb))
    out = torch.zeros((S, A_pad, LANE), dtype=x.dtype, device=x.device)
    idx = idx.long()
    for p, d in enumerate(d_offsets):
        w = xp[:, padb + d:padb + d + A_pad]
        out = out + vals[:, p] * torch.gather(w, 2, idx[:, p])
    return out.reshape(S, -1)[:, :rows_pad]


# --- windowed ELL (transfer operators with narrow per-tile column spans) --------
#
# Per tile of ba*128 consecutive rows, x is read only inside a window of WR
# 128-blocks starting at ws[tile]; the layout stores the window start and
# window-relative column ids (int32, half the bytes of ELL's int64 columns).

def _wind_slot_assign(q, rows, tid, row_nnz, W, T):
    """Assign each CSR entry to an ELL slot so per-(tile, slot)
    window-row bands stay narrow: slots are bucketed by the entry's
    position in its tile's window-row range, made strictly increasing
    within a row by a running max, then capped into [0, W-1]."""
    k = np.arange(len(q)) - np.repeat(
        np.cumsum(np.concatenate([[0], row_nnz[:-1]])), row_nnz)
    tlo = np.full(T, np.iinfo(np.int64).max, dtype=np.int64)
    thi = np.full(T, -1, dtype=np.int64)
    np.minimum.at(tlo, tid, q)
    np.maximum.at(thi, tid, q)
    span = np.maximum(1, thi - tlo)
    t_e = np.minimum(W - 1, (q - tlo[tid]) * W // span[tid])
    # per-row running max via a row-offset segmented scan; BIG need only
    # exceed the value range of (t_e - k)
    BIG = np.int64(W + int(row_nnz.max(initial=1)) + 2)
    assert int(rows[-1] if len(rows) else 0) < np.iinfo(np.int64).max // BIG
    fwd = np.maximum.accumulate(t_e - k + rows * BIG) - rows * BIG
    s = k + np.minimum(fwd, W - np.repeat(row_nnz, row_nnz))
    return s


def wind_ell_stats(a: CSRMatrix, rows_pad: int, ba: int):
    """(W, WR, T, scan) for the windowed-ELL layout at tile size ba*128:
    the ELL row width, the max per-tile window height in 128-blocks from
    the 8-aligned window base (rounded up to a multiple of 8), the tile
    count, and the (tile, slot, window-row) steps that the per-slot bounds
    ``jlo``/``jhi`` of ``wind_ell_arrays`` span."""
    row_nnz = np.diff(a.indptr)
    W = int(row_nnz.max()) if a.nnz else 0
    TR = ba * LANE
    T = -(-_round_up(max(rows_pad, a.n_rows, 1), TR) // TR)
    if a.nnz == 0:
        return W, 8, T, 0
    rows = np.repeat(np.arange(a.n_rows), row_nnz)
    q = (a.indices // LANE).astype(np.int64)
    tid = rows // TR
    lo = np.full(T, np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.zeros(T, dtype=np.int64)
    np.minimum.at(lo, tid, q)
    np.maximum.at(hi, tid, q)
    occ = lo <= hi
    span = int(np.max(hi[occ] - (lo[occ] & ~7) + 1, initial=1))
    pos = _wind_slot_assign(q, rows, tid, row_nnz, W, T)
    flat = tid * W + pos
    slo = np.full(T * W, np.iinfo(np.int64).max, dtype=np.int64)
    shi = np.full(T * W, -1, dtype=np.int64)
    np.minimum.at(slo, flat, q)
    np.maximum.at(shi, flat, q)
    act = shi >= 0
    scan = int(np.sum(shi[act] - slo[act] + 1))
    return W, int(_round_up(span, 8)), T, scan


def wind_ell_arrays(a: CSRMatrix, rows_pad: int, W: int, WR: int, ba: int,
                    cols_pad: int, dtype=np.float64):
    """Pack CSR into windowed ELL.

    Returns (ws [T] int32 8-aligned window starts in 128-blocks of the
    source vector, rel [W, R] int32 window-relative cols = col - 128*ws,
    vals [W, R], jlo [T, W] int32, jhi [T, W] int32), R = rows_pad rounded
    up to ba*128. Padding entries have rel 0 / val 0. ws is clamped so
    ws + WR never exceeds ``wind_src_height``. jlo/jhi are the TPU
    kernel's per-(tile, slot) window-row scan bounds (half-open, empty
    pairs [0, 0)); they are packed so the layouts compare byte for byte,
    and the CUDA kernel does not read them."""
    TR = ba * LANE
    R = _round_up(max(rows_pad, a.n_rows, 1), TR)
    T = R // TR
    cap = max(0, wind_src_height(cols_pad, WR) - WR)
    ws = np.zeros(T, dtype=np.int32)
    rel = np.zeros((W, R), dtype=np.int32)
    vals = np.zeros((W, R), dtype=dtype)
    jlo = np.zeros((T, W), dtype=np.int32)
    jhi = np.zeros((T, W), dtype=np.int32)
    if a.nnz:
        row_nnz = np.diff(a.indptr)
        rows = np.repeat(np.arange(a.n_rows), row_nnz)
        q = (a.indices // LANE).astype(np.int64)
        tid = rows // TR
        pos = _wind_slot_assign(q, rows, tid, row_nnz, W, T)
        lo = np.full(T, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(lo, tid, q)
        lo[lo == np.iinfo(np.int64).max] = 0
        ws[:] = np.minimum(lo & ~7, cap)
        r = a.indices - ws[tid].astype(np.int64) * LANE
        assert r.min() >= 0 and r.max() < WR * LANE, \
            (int(r.min()), int(r.max()), WR * LANE)
        rel[pos, rows] = r
        vals[pos, rows] = a.data
        qrel = q - ws[tid]
        flat = tid * W + pos
        slo = np.full(T * W, np.iinfo(np.int64).max, dtype=np.int64)
        shi = np.full(T * W, -1, dtype=np.int64)
        np.minimum.at(slo, flat, qrel)
        np.maximum.at(shi, flat, qrel)
        act = shi >= 0
        slo[~act] = 0
        jlo[:] = slo.reshape(T, W)
        jhi[:] = (shi + 1).reshape(T, W).clip(min=0)
    return ws, rel, vals, jlo, jhi


def wind_src_height(cols_pad: int, WR: int) -> int:
    """Padded source-vector height (in 128-blocks) of the windowed layout:
    the packer clamps ws with it, and the plain SpMV pads x to it."""
    return _round_up(max(-(-cols_pad // LANE), WR), 8)


def wind_ell_cols(ws: torch.Tensor, rel: torch.Tensor,
                  ba: int) -> torch.Tensor:
    """Absolute int64 ELL cols [S, W, R] from the windowed layout."""
    S, W, R = rel.shape
    T = R // (ba * LANE)
    return (rel.reshape(S, W, T, ba * LANE).long()
            + ws.long()[:, None, :, None] * LANE).reshape(S, W, R)


def wind_ell_spmv(ws: torch.Tensor, rel: torch.Tensor, vals: torch.Tensor,
                  x: torch.Tensor, ba: int, WR: int,
                  rows_pad: int) -> torch.Tensor:
    """b[s, r] = sum_w vals[s,w,r] * x[s, ws[s, r // (ba*128)]*128 +
    rel[s,w,r]], x zero-padded to ``wind_src_height``; returns
    [S, rows_pad]."""
    cols = wind_ell_cols(ws, rel, ba)
    need = wind_src_height(x.shape[1], WR) * LANE
    x2 = F.pad(x, (0, need - x.shape[1]))
    return (vals * _take(x2, cols)).sum(dim=1)[:, :rows_pad]


# --- sorted-scatter windowed transpose ("wellt", the restriction format) --------
#
# The FORWARD matrix B (rows = x domain, cols = targets; for a restriction
# operator A = P^T this is P itself) is tiled in 128 source rows; each tile's
# entries are sorted by target 128-row-block and compacted into slots of
# 128 entries whose targets all fall in one aligned SWELLT_AMAX-row output
# window. y = B^T x is then a scatter-add of vals * x over the entries.

SWELLT_AMAX = 32        # output rows per slot window (multiple of 8)


def swellt_height(n_out: int) -> int:
    """Padded output height (in 128-blocks): every slot's window
    [qb, qb + SWELLT_AMAX) stays in bounds."""
    return _round_up(-(-max(n_out, 1) // LANE) + SWELLT_AMAX, 8)


def _swellt_entries(a: CSRMatrix):
    """Per-entry (tile, srcl, hc, lout, qb, key) in CSR order, the slot
    sort order, and the window count. Shared by stats and pack."""
    row_nnz = np.diff(a.indptr)
    rows = np.repeat(np.arange(a.n_rows), row_nnz)
    tid = rows >> 7
    srcl = rows & 127
    hc = (a.indices // LANE).astype(np.int64)
    lout = a.indices % LANE
    qb = (hc // SWELLT_AMAX) * SWELLT_AMAX
    nq = int(qb.max()) // SWELLT_AMAX + 1 if a.nnz else 1
    key = tid.astype(np.int64) * nq + qb // SWELLT_AMAX
    order = np.argsort(key, kind="stable")
    return (tid, srcl, hc, lout, qb, key, order, nq)


def swellt_stats(a: CSRMatrix) -> Tuple[int, int]:
    """(T, Kp): tile count and max slots per tile (no sort needed)."""
    T = max(1, -(-a.n_rows // LANE))
    if a.nnz == 0:
        return T, 0
    row_nnz = np.diff(a.indptr)
    rows = np.repeat(np.arange(a.n_rows), row_nnz)
    tid = rows >> 7
    qi = (a.indices // (LANE * SWELLT_AMAX)).astype(np.int64)
    nq = int(qi.max()) + 1
    cnt = np.bincount(tid * nq + qi, minlength=T * nq)
    slots = -(-cnt // LANE)
    Kp = int(slots.reshape(T, nq).sum(axis=1).max())
    return T, Kp


def swellt_arrays(a: CSRMatrix, Kp: int, dtype=np.float64):
    """Pack the forward matrix into the sorted-scatter layout.

    Returns (meta [T, Kp*128] int32, vals [T, Kp*128], qb [T*Kp] int32).
    meta packs srcl | qrel << 7 | lout << 12. Padding entries carry val 0 /
    meta 0 / qb 0."""
    T = max(1, -(-a.n_rows // LANE))
    meta = np.zeros((T, Kp * LANE), dtype=np.int32)
    vals = np.zeros((T, Kp * LANE), dtype=dtype)
    qbs = np.zeros(T * Kp, dtype=np.int32)
    if a.nnz == 0 or Kp == 0:
        return meta, vals, qbs
    tid, srcl, hc, lout, qb, key, order, nq = _swellt_entries(a)
    tid, srcl, lout, qb, key = (v[order] for v in (tid, srcl, lout, qb,
                                                   key))
    qrel = (hc - (hc // SWELLT_AMAX) * SWELLT_AMAX)[order]
    data = a.data[order]
    n = len(key)
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = key[1:] != key[:-1]
    gid = np.cumsum(new) - 1
    gstart = np.flatnonzero(new)
    p = np.arange(n) - gstart[gid]
    sig = p // LANE                       # slot within its group
    e = p % LANE                          # lane position within slot
    gsize = np.diff(np.append(gstart, n))
    gslots = -(-gsize // LANE)
    gtile = tid[gstart]
    cum = np.cumsum(gslots) - gslots
    tfirst = np.flatnonzero(np.r_[True, gtile[1:] != gtile[:-1]])
    tbase = np.repeat(cum[tfirst],
                      np.diff(np.append(tfirst, len(gslots))))
    k = (cum - tbase)[gid] + sig          # slot index within the tile
    assert int(k.max()) < Kp, (int(k.max()), Kp)
    meta[tid, k * LANE + e] = (srcl | (qrel << 7) | (lout << 12)) \
        .astype(np.int32)
    vals[tid, k * LANE + e] = data
    qbs[tid * Kp + k] = qb
    return meta, vals, qbs


def swellt_counts(vals: np.ndarray) -> np.ndarray:
    """Real entries of each slot of a packed sorted-scatter layout ``vals
    [T, Kp*128]``: ``[T*Kp]`` int32, 1 + the last lane whose value is
    nonzero, 0 for an unused slot. The packer fills a slot from lane 0, so
    its padding is the suffix past the count, which the kernel never
    reads."""
    nz = vals.reshape(-1, LANE) != 0
    last = LANE - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


def _swellt_src_tgt(meta: torch.Tensor, qb: torch.Tensor):
    """Per-entry source index (tile*128 + srcl) and target index
    ((qb + qrel)*128 + lout), both int64 [S, T, Kp*128]."""
    S, T, KL = meta.shape
    m = meta.long()
    srcl, qrel, lout = m & 127, (m >> 7) & (SWELLT_AMAX - 1), (m >> 12) & 127
    src = torch.arange(T, device=meta.device)[None, :, None] * LANE + srcl
    qbe = qb.long().reshape(S, T, KL // LANE).repeat_interleave(LANE, dim=2)
    return src, (qbe + qrel) * LANE + lout


def swellt_spmv_T(meta: torch.Tensor, vals: torch.Tensor, qb: torch.Tensor,
                  x: torch.Tensor, n_out: int) -> torch.Tensor:
    """y = B^T x from the sorted-scatter layout: y[s, tgt] += vals * x[s,
    src] over every entry; returns [S, n_out]."""
    S, T, _ = meta.shape
    src, tgt = _swellt_src_tgt(meta, qb)
    xp = F.pad(x, (0, T * LANE - x.shape[1]))
    c = vals * _take(xp, src)
    H = swellt_height(n_out)
    y = torch.zeros((S, H * LANE), dtype=vals.dtype, device=vals.device)
    y.scatter_add_(1, tgt.reshape(S, -1), c.reshape(S, -1))
    return y[:, :n_out]


def swellt_spmv(meta: torch.Tensor, vals: torch.Tensor, qb: torch.Tensor,
                x: torch.Tensor, cols_pad: int) -> torch.Tensor:
    """Forward apply y = B x from the sorted-scatter layout (the spmv_T of
    a wellt-packed restriction operator); returns [S, cols_pad]."""
    S, T, _ = meta.shape
    src, tgt = _swellt_src_tgt(meta, qb)
    H = swellt_height(x.shape[1])
    xp = F.pad(x, (0, H * LANE - x.shape[1]))
    c = vals * _take(xp, tgt)
    y = torch.zeros((S, T * LANE), dtype=vals.dtype, device=vals.device)
    y.scatter_add_(1, src.reshape(S, -1), c.reshape(S, -1))
    return y[:, :cols_pad]


# --- BELL (block-ELL of BDIA plane slots) ------------------------------------------
#
# For each target 128-row block, up to W_b slots, each holding ONE source
# 128-column block with per-row lane ids (int8) and values: the SpMV streams
# only occupied blocks where full BDIA planes stream every block.

def bell_stats(a: CSRMatrix):
    """(W_b, n_slots) for the BELL layout: per-target-128-block count of
    (block-offset, occurrence) plane slots; W_b is the max over blocks."""
    if a.nnz == 0:
        return 0, 0
    rows, d, slot = _bdia_d_slot(a)
    blk = (rows // LANE).astype(np.int64)
    c128 = max(1, (a.n_cols + LANE - 1) // LANE)
    span = np.int64(int(slot.max()) + 2)
    key = (blk * np.int64(2 * c128 + 3) + (d + c128)) * span + slot
    uk = np.unique(key)
    u_blk = uk // (np.int64(2 * c128 + 3) * span)
    a128 = max(1, (a.n_rows + LANE - 1) // LANE)
    counts = np.bincount(u_blk.astype(np.int64), minlength=a128)
    return int(counts.max()), int(len(uk))


def bell_arrays(a: CSRMatrix, a128: int, w_b: int, dtype=np.float64):
    """Pack CSR into BELL. Returns (src [W_b, a128] int32 source block ids
    (pad: 0, vals 0), idx [W_b, a128, 128] int8 lane ids,
    vals [W_b, a128, 128])."""
    src = np.zeros((w_b, a128), dtype=np.int32)
    idx = np.zeros((w_b, a128, LANE), dtype=np.int8)
    vals = np.zeros((w_b, a128, LANE), dtype=dtype)
    if a.nnz == 0 or w_b == 0:
        return src, idx, vals
    rows, d, slot = _bdia_d_slot(a)
    blk = (rows // LANE).astype(np.int64)
    srcb = (a.indices // LANE).astype(np.int64)
    lane = (a.indices % LANE).astype(np.int64)
    sub = (rows % LANE).astype(np.int64)
    c128 = max(1, (a.n_cols + LANE - 1) // LANE)
    span = np.int64(int(slot.max()) + 2)
    key = (blk * np.int64(2 * c128 + 3) + (d + c128)) * span + slot
    uk, first, inv = np.unique(key, return_index=True,
                               return_inverse=True)
    u_blk = blk[first]
    u_src = srcb[first]
    counts = np.bincount(u_blk, minlength=a128)
    starts = np.cumsum(counts) - counts
    # uk is sorted block-major, so slot rank within its block:
    w_of = np.arange(len(uk)) - starts[u_blk]
    src[w_of, u_blk] = u_src
    w_e = w_of[inv]
    idx[w_e, blk, sub] = lane
    vals[w_e, blk, sub] = a.data
    return src, idx, vals


def bell_counts(vals: np.ndarray) -> np.ndarray:
    """Real slots of each row block of a packed BELL layout ``vals [W_b,
    a128, 128]``: ``[a128]`` int32, 1 + the last w whose slot holds a
    nonzero value, 0 when none does. ``bell_arrays`` gives a block's slots
    the ranks 0, 1, ... in turn, so the slots past the count are padding,
    which the kernel never reads."""
    cnt = np.zeros(vals.shape[1], dtype=np.int32)
    for w in range(vals.shape[0]):  # one layer at a time: no full bool copy
        cnt[(vals[w] != 0).any(axis=1)] = w + 1
    return cnt


def bell_spmv(src: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor, rows_pad: int) -> torch.Tensor:
    """out[s, a*128 + l] = sum_w vals[s,w,a,l] * x[s, src[s,w,a]*128 +
    idx[s,w,a,l]], one slot layer at a time; returns [S, rows_pad]."""
    S, W, A128 = src.shape
    C128 = -(-x.shape[1] // LANE)
    x2 = F.pad(x, (0, C128 * LANE - x.shape[1])).reshape(S, C128, LANE)
    out = torch.zeros((S, A128, LANE), dtype=x.dtype, device=x.device)
    for w in range(W):
        blocks = src[:, w].long()[:, :, None].expand(-1, -1, LANE)
        wrow = torch.gather(x2, 1, blocks)               # [S, A128, 128]
        out = out + vals[:, w] * torch.gather(wrow, 2, idx[:, w].long())
    return out.reshape(S, -1)[:, :rows_pad]
