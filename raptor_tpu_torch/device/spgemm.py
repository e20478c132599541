"""Sparse matrix-matrix products on the device: the Galerkin product
P^T A P of the AMG setup (copy of raptor_tpu.device.spgemm in torch ops).

The reference forms AP = A P and Ac = P^T (AP) with a sequential Gustavson
SpGEMM on the host (util/linalg/par_matmult.cpp:79-441,
matmult.cpp:90-226); the port's host engine is the native copy of it. The
device engine has no hash table and no data-dependent control flow inside a
row chunk:

  1. EXPAND   each output row's candidate entries into a padded slab of
              shape [Wc, C] (candidate slot major, one output row per
              column; C is a row chunk). For an ELL left operand the
              candidates are gathers of B's rows; for a DIA (stencil) left
              operand they are shifted slices of a pre-padded B window,
              with no gather at all.
  2. SORT     along dim 0 (``torch.sort(dim=0, stable=True)`` on the
              columns, the values gathered with the permutation).
  3. MERGE    duplicate columns by a segmented sum, the linear recurrence
              s_j = v_j + [c_j == c_{j-1}] s_{j-1} evaluated by a log-step
              scan in a fixed order (no atomics: two runs give the same
              bytes), keeping the last element of each run.
  4. COMPACT  the survivors to the front with a second stable sort on
              (kept ? col : SENT) and slice to a width cap.

The host reads back only the per-row counts and the [w_cap, C] output of
each chunk and assembles the CSR. When a row outgrows the cap, the product
runs once more at the measured width (``_merge_compact`` says which); if
that still overflows, ``CapOverflow`` tells the caller to use the host
engine. Nothing else is caught: any other error propagates.

The default precision is float64 on every device (the H100 computes it
natively); ``dtype`` selects float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.types import ZERO_TOL
from raptor_tpu_torch.device.par import resolve_device

SENT = np.int32(2**31 - 1)  # sentinel column id: sorts after any real col

# candidate-slab byte budget per chunk (cols + vals buffers each)
_SLAB_BYTES = 256 * 1024 * 1024

# slabs taller than this merge as a tree (see _merge_compact)
_MERGE_GROUP = 1024


def np_dtype(dtype) -> np.dtype:
    """The engines' value dtype: float64 unless asked otherwise."""
    return np.dtype(np.float64 if dtype is None else dtype)


def upload(x: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` (one copy)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# --- packing (host) ----------------------------------------------------------

def csr_to_ell(a: CSRMatrix, dtype=np.float64
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR as [W, n] ELL (slot major, row minor). Padding slots hold
    col = SENT and val = 0, so they sort to the end and merge to nothing."""
    n = a.n_rows
    row_nnz = np.diff(a.indptr)
    W = max(1, int(row_nnz.max()) if a.nnz else 1)
    cols = np.full((W, n), SENT, dtype=np.int32)
    vals = np.zeros((W, n), dtype=dtype)
    if a.nnz:
        rows = np.repeat(np.arange(a.n_rows), row_nnz)
        pos = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
        cols[pos, rows] = a.indices
        vals[pos, rows] = a.data
    return cols, vals


def csr_to_dia(a: CSRMatrix, max_diags: int = 48
               ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """[K] offsets and [K, n] values per diagonal when the matrix is a
    stencil (at most ``max_diags`` distinct col - row offsets); else
    None."""
    if a.nnz == 0:
        return None
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    d = a.indices.astype(np.int64) - rows
    offsets = np.unique(d)
    if len(offsets) > max_diags:
        return None
    k = np.searchsorted(offsets, d)
    vals = np.zeros((len(offsets), a.n_rows), dtype=a.data.dtype)
    vals[k, rows] = a.data
    return offsets, vals


# --- the device engine (torch ops on the operands' device) --------------------

def _segmented_sum(same: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """s_j = v_j + same_j * s_{j-1} along dim 0, by a Hillis-Steele scan
    of the recurrence's pairs (a, s): step d combines row j with row
    j - d. The order of every addition is fixed by the shape, and the scan
    stops once no row links to the one d above it."""
    a, s = same, v
    d, H = 1, v.shape[0]
    while d < H and bool(a[d:].any()):
        s = torch.cat([s[:d], s[d:] + torch.where(a[d:], s[:-d],
                                                  torch.zeros_like(s[d:]))])
        a = torch.cat([a[:d], a[d:] & a[:-d]])
        d *= 2
    return s


def _merge_compact(cand_c: torch.Tensor, cand_v: torch.Tensor,
                   w_cap: int, zero_tol: float):
    """Steps 2-4 on a [H, C] candidate slab: ([w_cap, C] cols,
    [w_cap, C] vals, [C] int32 counts, 0-d max count).

    Slabs taller than ``_MERGE_GROUP`` merge as a tree, as the JAX
    package's do: each group of rows is merged and cut to w_cap, then the
    group results merge once more. Inside the groups nothing is dropped
    that the final merge would keep (exact zeros only, and none when
    ``zero_tol`` is negative), so partial sums go on cancelling. When no
    group was cut, the max count is the exact widest row. When one was,
    entries are lost and the final counts fall short; the max count is
    then the largest sum of a row's group counts, a width at which the
    caller's retry cuts no group. (The JAX package reports the largest
    group count there, which can stay under the true width, so that its
    retry overflows again.)"""
    H = cand_c.shape[0]
    # groups of at least 2 w_cap, so the re-merge height n_g * w_cap is at
    # most H / 2
    G = max(_MERGE_GROUP, 2 * w_cap)
    if H > G:
        n_g = -(-H // G)
        pad = n_g * G - H
        if pad:
            cand_c = torch.cat([cand_c, cand_c.new_full(
                (pad,) + cand_c.shape[1:], int(SENT))])
            cand_v = torch.cat([cand_v, cand_v.new_zeros(
                (pad,) + cand_v.shape[1:])])
        group_tol = min(zero_tol, 0.0)
        ks, vs, cs = [], [], []
        for g in range(n_g):
            k, s, c, _ = _merge_compact(cand_c[g * G:(g + 1) * G],
                                        cand_v[g * G:(g + 1) * G],
                                        w_cap, group_tol)
            ks.append(k)
            vs.append(s)
            cs.append(c)
        key, sval, counts, m2 = _merge_compact(
            torch.cat(ks), torch.cat(vs), w_cap, zero_tol)
        group_counts = torch.stack(cs)
        cut = group_counts.max() > w_cap
        bound = torch.maximum(group_counts.sum(0).max(), m2)
        return key, sval, counts, torch.where(cut, bound, m2)
    c, perm = torch.sort(cand_c, dim=0, stable=True)
    v = torch.gather(cand_v, 0, perm)
    same = torch.cat([torch.zeros_like(c[:1], dtype=torch.bool),
                      c[1:] == c[:-1]])
    s = _segmented_sum(same, v)
    # the last of each run; drop sentinels and |sum| <= zero_tol
    last = torch.cat([c[:-1] != c[1:],
                      torch.ones_like(c[:1], dtype=torch.bool)])
    keep = last & (c != int(SENT)) & (s.abs() > zero_tol)
    key = torch.where(keep, c, torch.full_like(c, int(SENT)))
    sval = torch.where(keep, s, torch.zeros_like(s))
    key, perm = torch.sort(key, dim=0, stable=True)
    sval = torch.gather(sval, 0, perm)
    counts = keep.sum(dim=0, dtype=torch.int32)
    return key[:w_cap], sval[:w_cap], counts, counts.max()


def ell_spgemm(a_cols, a_vals, b_cols, b_vals, w_cap: int,
               zero_tol: float = ZERO_TOL):
    """C = A B for one row chunk of A ([Wa, C] ELL) against all of B
    ([Wb, n] ELL): the candidates are B's rows gathered by A's columns."""
    _, C = a_cols.shape
    active = a_cols != int(SENT)
    safe = torch.where(active, a_cols, torch.zeros_like(a_cols)).long()
    bc = b_cols[:, safe]                            # [Wb, Wa, C]
    bv = b_vals[:, safe]
    valid = active & (bc != int(SENT))
    cand_c = torch.where(valid, bc, torch.full_like(bc, int(SENT)))
    cand_v = torch.where(valid, a_vals[None] * bv, torch.zeros_like(bv))
    return _merge_compact(cand_c.reshape(-1, C), cand_v.reshape(-1, C),
                          w_cap, zero_tol)


def dia_ell_spgemm(rel_offsets: tuple, dia_vals, b_cols_w, b_vals_w,
                   w_cap: int, zero_tol: float = ZERO_TOL):
    """C = A B for a stencil A ([K, C] diagonal values of one row chunk)
    against a pre-padded window of B ([Wb, C + span]): the candidates are
    slices of the window, shifted by ``rel_offsets[k] = offset_k -
    min(offsets)``; no gather. This is the fine level's path, where most
    of the Galerkin work is."""
    K, C = dia_vals.shape
    cc, cv = [], []
    for k, r in enumerate(rel_offsets):
        bc = b_cols_w[:, r:r + C]
        bv = b_vals_w[:, r:r + C]
        valid = bc != int(SENT)
        cc.append(bc)            # padding already holds SENT
        cv.append(torch.where(valid, dia_vals[k][None] * bv,
                              torch.zeros_like(bv)))
    return _merge_compact(torch.cat(cc), torch.cat(cv), w_cap, zero_tol)


# --- host wrappers -----------------------------------------------------------

class CapOverflow(Exception):
    """A row of the product outgrew the width cap even after the
    exact-width retry; the caller computes it with the host engine."""


def _assemble_csr(n_rows: int, n_cols: int, cols_np: np.ndarray,
                  vals_np: np.ndarray, counts: np.ndarray) -> CSRMatrix:
    """[w_cap, >= n_rows] device output as a canonical CSR."""
    cols = cols_np[:, :n_rows].T           # [n, w_cap]
    vals = vals_np[:, :n_rows].T
    counts = counts[:n_rows]
    mask = np.arange(cols.shape[1])[None, :] < counts[:, None]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSRMatrix(n_rows, n_cols, indptr,
                     cols[mask].astype(np.int64),
                     vals[mask].astype(np.float64))


def _chunk_rows(n: int, w_cand: int, itemsize: int) -> int:
    """Rows per chunk: the candidate slab (cols + vals) stays under its
    budget; a multiple of 512."""
    per_row = w_cand * max(itemsize, 4)
    c = max(512, _SLAB_BYTES // max(per_row, 1))
    c = min(c, n)
    return -(-c // 512) * 512


class _DeviceProduct:
    """One product C = A B, chunked over A's rows with equal shapes. Its
    padded output stays on the device ([w_cap, C] per chunk), so that the
    next product can take it as its ELL operand without a readback
    (``rap_device`` feeds AP into P^T (AP))."""

    def __init__(self, n_rows, n_cols, chunks, counts):
        self.n_rows, self.n_cols = n_rows, n_cols
        self.chunks = chunks          # [(cols [w, C], vals [w, C])]
        self.counts = counts          # np [n_rows]

    @property
    def nnz(self) -> int:
        return int(self.counts.sum())

    def to_ell(self):
        """The chunk outputs as one [w, n_pad] device ELL (cols, vals):
        the operand format of ``ell_spgemm``."""
        return (torch.cat([c for c, _ in self.chunks], dim=1),
                torch.cat([v for _, v in self.chunks], dim=1))

    def to_csr(self) -> CSRMatrix:
        cols, vals = self.to_ell()
        return _assemble_csr(self.n_rows, self.n_cols, cols.cpu().numpy(),
                             vals.cpu().numpy(), self.counts)


def _finish(chunks, counts, mxs, n_rows, n_cols_out, w_cap):
    """(product, max count): one readback of the counts and of the max
    for the whole product; no product when a row outgrew ``w_cap``."""
    mx = int(torch.stack(mxs).max())
    if mx > w_cap:
        return None, mx
    counts = torch.cat(counts).cpu().numpy()[:n_rows]
    return _DeviceProduct(n_rows, n_cols_out, chunks, counts), mx


def _run_dia(offsets, dv, bc, bv, n_rows, n_cols_out, w_cap, dtype, device):
    """Chunked DIA x ELL. B is padded on the host so that every chunk's
    window is one slice of a single upload."""
    K, n = dv.shape
    dmin, dmax = int(offsets[0]), int(offsets[-1])
    span = dmax - dmin
    rel = tuple(int(d) - dmin for d in offsets)
    C = _chunk_rows(n, K * bc.shape[0], dv.dtype.itemsize)
    n_pad = -(-n // C) * C
    # padded B: bp[:, j] = b[:, j + dmin] over j in [0, n_pad + span)
    lo = max(0, -dmin)
    bc_p = np.pad(bc[:, max(0, dmin):min(bc.shape[1], n_pad + dmax)],
                  ((0, 0), (lo, 0)), constant_values=SENT)
    bv_p = np.pad(bv[:, max(0, dmin):min(bv.shape[1], n_pad + dmax)],
                  ((0, 0), (lo, 0)))
    need = n_pad + span
    if bc_p.shape[1] < need:
        pad = need - bc_p.shape[1]
        bc_p = np.pad(bc_p, ((0, 0), (0, pad)), constant_values=SENT)
        bv_p = np.pad(bv_p, ((0, 0), (0, pad)))
    dv_p = np.zeros((K, n_pad), dtype=dtype)
    dv_p[:, :n] = dv
    bc_d = upload(bc_p, device)
    bv_d = upload(bv_p.astype(dtype), device)
    dv_d = upload(dv_p, device)
    chunks, counts, mxs = [], [], []
    for s in range(0, n_pad, C):
        cols_d, vals_d, cnt, m = dia_ell_spgemm(
            rel, dv_d[:, s:s + C], bc_d[:, s:s + C + span],
            bv_d[:, s:s + C + span], w_cap)
        chunks.append((cols_d, vals_d))
        counts.append(cnt)
        mxs.append(m)
    return _finish(chunks, counts, mxs, n_rows, n_cols_out, w_cap)


def _run_ell(ac, av, bc_d, bv_d, n_rows, n_cols_out, w_cap, dtype, device):
    """Chunked ELL x ELL; B stays on the device across the chunks (it may
    be the device output of the previous product)."""
    Wa, n = ac.shape
    Wb = bc_d.shape[0]
    C = _chunk_rows(n, Wa * Wb, np.dtype(dtype).itemsize)
    n_pad = -(-n // C) * C
    if n_pad > n:
        ac = np.pad(ac, ((0, 0), (0, n_pad - n)), constant_values=SENT)
        av = np.pad(av, ((0, 0), (0, n_pad - n)))
    ac_d = upload(ac, device)
    av_d = upload(av.astype(dtype, copy=False), device)
    chunks, counts, mxs = [], [], []
    for s in range(0, n_pad, C):
        cols_d, vals_d, cnt, m = ell_spgemm(
            ac_d[:, s:s + C], av_d[:, s:s + C], bc_d, bv_d, w_cap)
        chunks.append((cols_d, vals_d))
        counts.append(cnt)
        mxs.append(m)
    return _finish(chunks, counts, mxs, n_rows, n_cols_out, w_cap)


def _cap_guess(a_max_row: int, b_max_row: int, n_cols: int) -> int:
    """The first width cap; an overflow re-runs once at the exact max."""
    return int(min(max(16, a_max_row + 4 * b_max_row),
                   a_max_row * b_max_row, n_cols))


def _max_row(a: CSRMatrix) -> int:
    return max(1, int(np.diff(a.indptr).max()) if a.nnz else 1)


def spgemm_device(a: CSRMatrix, b: CSRMatrix, dtype=None,
                  w_cap: Optional[int] = None,
                  device="cuda") -> CSRMatrix:
    """C = A B on ``device``, in the host kernel's canonical form (sorted
    columns, duplicates merged, |c| <= ZERO_TOL dropped), equal to it up to
    the roundoff of the summation order in ``dtype``."""
    return _product(a, b, dtype, w_cap, resolve_device(device)).to_csr()


def _product(a: CSRMatrix, b: CSRMatrix, dtype, w_cap: Optional[int],
             device) -> _DeviceProduct:
    dtype = np_dtype(dtype)
    if w_cap is None:
        w_cap = _cap_guess(_max_row(a), _max_row(b), b.n_cols)
    bc, bv = csr_to_ell(b, dtype=dtype)
    dia = csr_to_dia(a)
    if dia is None:
        ac, av = csr_to_ell(a, dtype=dtype)
        bc_d, bv_d = upload(bc, device), upload(bv, device)
    for _ in range(2):
        if dia is not None:
            prod, mx = _run_dia(dia[0], dia[1].astype(dtype), bc, bv,
                                a.n_rows, b.n_cols, w_cap, dtype, device)
        else:
            prod, mx = _run_ell(ac, av, bc_d, bv_d, a.n_rows, b.n_cols,
                                w_cap, dtype, device)
        if prod is not None:
            return prod
        tried, w_cap = w_cap, min(mx, b.n_cols)    # the measured width
    raise CapOverflow(f"row width {mx} > cap {tried}")


def rap_device(a: CSRMatrix, p: CSRMatrix, dtype=None,
               need_ap: bool = True, device="cuda"):
    """(AP, Ac = P^T A P, nnz of AP) with both products on ``device``.

    AP does not leave the device between the two products: its padded
    [w_cap, n] output is the ELL operand of P^T (AP), cut to AP's measured
    widest row. P^T is packed on the host (one structural transpose of P).
    AP is read back only when ``need_ap``. Raises ``CapOverflow`` when a
    row outgrows its exact-width retry."""
    device = resolve_device(device)
    dtype = np_dtype(dtype)
    app = _product(a, p, dtype, None, device)
    pt = p.transpose()
    ptc, ptv = csr_to_ell(pt, dtype=dtype)
    apc_d, apv_d = app.to_ell()
    # the second slab grows with AP's operand width: cut it to AP's widest
    # row (rows past the counts are SENT/0 padding, so the cut loses
    # nothing) rather than the first product's cap
    ap_max_row = max(1, int(app.counts.max()) if len(app.counts) else 1)
    if ap_max_row < apc_d.shape[0]:
        apc_d, apv_d = apc_d[:ap_max_row], apv_d[:ap_max_row]
    w_cap = _cap_guess(_max_row(pt), ap_max_row, p.n_cols)
    for _ in range(2):
        prod, mx = _run_ell(ptc, ptv, apc_d, apv_d, pt.n_rows, p.n_cols,
                            w_cap, dtype, device)
        if prod is not None:
            ap = app.to_csr() if need_ap else None
            return ap, prod.to_csr(), app.nnz
        tried, w_cap = w_cap, min(mx, p.n_cols)
    raise CapOverflow(f"row width {mx} > cap {tried}")
