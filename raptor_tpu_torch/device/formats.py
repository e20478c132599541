"""Device sparse formats: NumPy packers and their plain PyTorch SpMVs
(copy of raptor_tpu.device.formats for the ELL, DIA and BDIA formats).

Every function that takes tensors works on STACKED shards: a leading axis
``S`` over the partition's shards, so one call does what the JAX package
runs once per shard under ``shard_map``. Index tensors are int64 (torch's
gather/scatter index type); BDIA lane ids stay int8, as the kernel reads
them. Padding entries point at column 0 with value 0, so the linear ops
need no masks.

``dia_spmv`` and ``bdia_spmv`` are the plain versions of the hand-written
CUDA kernels in ``raptor_tpu_torch/csrc``; ``device.kernels`` launches the
kernels on CUDA tensors and calls these on CPU tensors only.
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
