"""Stacked-shard device matrix and halo-exchange SpMV (copy of
raptor_tpu.device.par for the ELL, DIA, BDIA, windowed-ELL, sorted-scatter
transpose and BELL formats).

Each shard owns a padded row block split into an on_proc block (local
columns) and a boundary-compacted off_proc block (condensed halo columns).
The JAX package runs one shard per device under ``shard_map``; here every
array keeps the leading shard axis ``S`` on one device and the shard code
is written batched over it, so the 8-shard semantics of the JAX tests
carry over unchanged. One SpMV is

    send = x[s][send_idx[s]]            # [S_src, S_dst, Q] gather
    recv = send.transpose(0, 1)         # the all_to_all
    halo = recv[s].flat[halo_src[s]]    # into off_proc column order
    b    = on_spmv(x) + off_spmv(halo)

All shapes are padded alike across shards; padded entries are (col 0,
val 0), so the linear ops need no masks.

The on_proc format is chosen per matrix by the JAX package's structural
rules: DIA when the offset union has at most ``MAX_DIA_OFFSETS`` entries,
else BDIA when the kept planes carry at least 60% of the entries with
block offsets |d| <= 256, else ELL. A matrix headed for ELL is then
ranked against the transfer formats that its shape admits (JAX's
structural gates: windowed ELL ``well`` for R >= 2048, the sorted-scatter
transpose ``wellt`` for restriction-shaped blocks with C >= 2048, BELL for
prolongation-shaped blocks) by the bytes one apply streams in the port's
layout, and the smallest wins (``_transfer_bytes``). The JAX package ranks
them by nanosecond constants fitted on a TPU, which the port does not
carry. A forced format is never re-ranked. Every on-block SpMV but ELL's
goes through a hand-written CUDA kernel (``device.kernels``).

Given a transport (``tr``), the packer takes its pads, widths and format
statistics from the transport's allgathers and its halo plan from the
rank-local handshake (``comm.plan.build_comm_plan_spmd``), as the JAX
package's SPMD path does. A view of every shard gives the same stacked
tensors as ``tr=None``. A view of some shards (one controller's, over a
transport across processes) packs only those: the leading axis of every
array is then the view's shards, while the halo plan's second axis and
every pad stay global, so the packed rows equal the full stack's.

Across controllers (one shard each) the matrix carries the controller's
``comm.bootstrap.DeviceComm`` (``comm``): the halo exchange's transpose
of the send buffer becomes ``comm.all_to_all`` (the topology-aware
exchange's, all-to-alls over the comm's sub-groups: ``comm.tap``), and an
inner product gathers every controller's per-shard partial dots into
shard order (``comm.all_gather``) and sums them as the stacked route sums
its own, so every controller gets the same value. ``comm=None`` keeps
every shard on one device.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch
import torch.nn.functional as F

from raptor_tpu_torch.comm.plan import (
    CommPlan, build_comm_plan, build_comm_plan_spmd)
from raptor_tpu_torch.comm.tap import tap_halo_exchange, tap_halo_exchange_T
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.device import kernels
from raptor_tpu_torch.device.formats import (
    LANE, SWELLT_AMAX, _round_up, _scatter_add, _take, bdia_arrays,
    bdia_plane_counts, bdia_split_rest, bdia_tiles, bell_arrays, bell_counts,
    bell_stats, dia_arrays, dia_detect, dia_spmv_T, ell_arrays,
    ell_boundary_arrays, ell_spmv, ell_spmv_T, off_spmv, off_spmv_T,
    select_planes, swellt_arrays, swellt_counts, swellt_spmv, swellt_stats,
    well_slices, wind_ell_arrays, wind_ell_cols, wind_ell_stats)
from raptor_tpu_torch.profiling.timers import nested_phase

MAX_DIA_OFFSETS = 64
MAX_BDIA_PLANES = 1024
# cap on the bytes of the BDIA planes of one matrix (the JAX package's
# default RAPTOR_TPU_BDIA_MEM); it bounds the plane count of huge levels
BDIA_MEM_CAP = 3 << 30
FORMATS = ("ell", "well", "wellt", "bell")   # the forceable formats
WELL_BA = 8            # windowed-ELL tile: ba * 128 rows (the JAX layout)
TRANSFER_MIN = 2048    # well needs R, wellt C, at least this (JAX's gates)


@dataclasses.dataclass(frozen=True)
class Mesh2:
    """A (host, local) layout of ``n_hosts * n_local`` stacked shards:
    shard s is local shard s % n_local of host s // n_local. Every shard
    stays on one device; the layout only says which exchange steps of the
    topology-aware halo exchange (``comm.tap``) stay within a host."""

    n_hosts: int
    n_local: int
    axis_names: ClassVar[tuple] = ("host", "local")

    @property
    def shape(self) -> tuple:
        return (self.n_hosts, self.n_local)

    @property
    def n_shards(self) -> int:
        return self.n_hosts * self.n_local


def make_mesh2(n_hosts: int, n_local: int) -> Mesh2:
    """The (host, local) layout for topology-aware exchange (the JAX
    package's 2-D device mesh of the same name: ICI within "local", DCN
    across "host")."""
    return Mesh2(int(n_hosts), int(n_local))


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (the port never drops to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} asked for, but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"PyTorch versions")
    return dev


@dataclasses.dataclass
class DeviceParCSR:
    """Stacked-over-shards device matrix (leading axis = shard)."""

    on_cols: torch.Tensor    # [S, W_on, R] int64 (ELL; dummy otherwise);
    #                          well: [S, W, R_w] int32 window-relative cols;
    #                          wellt: [S, T, Kp*128] int32 meta
    on_vals: torch.Tensor    # [S, W_on, R] (well/wellt: as on_cols)
    off_rows: torch.Tensor   # [S, B] int64 boundary rows (pad = rows_pad)
    off_cols: torch.Tensor   # [S, W_off, B] int64 halo col ids
    off_vals: torch.Tensor   # [S, W_off, B]
    dia_vals: torch.Tensor   # [S, K, fmt_R] diagonals (dummy unless DIA)
    dia_off: torch.Tensor    # [K] int32 dia_offsets, for the kernel
    bd_idx: torch.Tensor     # [S, P, A_pad, 128] int8 lane ids
    bd_vals: torch.Tensor    # [S, P, A_pad, 128]
    bd_off: torch.Tensor     # [P] int32 bd_offsets, for the kernel
    bd_tptr: torch.Tensor    # [S, nblk+1] int32 and [S, Tmax] int32: the
    bd_tplane: torch.Tensor  # non-empty tiles (bdia_tiles); [S, 1] and
    #                          [S, 0] unless BDIA
    bl_src: torch.Tensor     # [S, W_b, A128] int32 BELL source block ids
    bl_idx: torch.Tensor     # [S, W_b, A128, 128] int8 lane ids
    bl_vals: torch.Tensor    # [S, W_b, A128, 128]
    bl_cnt: torch.Tensor     # [S, A128] int32 real slots per row block
    #                          (bell_counts); [S, 1] unless BELL
    rest_rows: torch.Tensor  # [S, Br] int64 (pad = fmt_R)
    rest_cols: torch.Tensor  # [S, Wr, Br] int64 local col ids
    rest_vals: torch.Tensor  # [S, Wr, Br]
    emb_idx: torch.Tensor    # [S, fmt_R/128] (cols) / [S, R/128] (rows)
    emb_mask: torch.Tensor   # [S, fmt_R/128] 1.0 on anchored blocks (cols)
    wl_ws: torch.Tensor      # well: [S, T] int32 8-aligned window starts;
    #                          wellt: [S, T*Kp] int32 per-slot window bases
    wl_jlo: torch.Tensor     # well: [S, T, W] int32 TPU scan bounds (packed
    wl_jhi: torch.Tensor     # for parity, unread); otherwise [S, 1, 1|W]
    wl_cnt: torch.Tensor     # wellt: [S, T*Kp] int32 real entries per slot
    #                          (swellt_counts); [S, 1] otherwise
    wl_perm: torch.Tensor    # well, sliced (well_slices): [S, R_w] int16
    wl_sptr: torch.Tensor    # row map, [S, R_w/32 + 1] int32 slice offsets,
    wl_crel: torch.Tensor    # [S, E] int16|int32 window-relative cols and
    wl_cvals: torch.Tensor   # [S, E] values of the real entries; [S, 1]
    #                          unless well
    send_idx: torch.Tensor   # [S, S, Q] int64 local col ids
    send_mask: torch.Tensor  # [S, S, Q]
    halo_src: torch.Tensor   # [S, H] int64 flat recv slot
    slot_to_halo: torch.Tensor  # [S, S, Q] int64
    recv_mask: torch.Tensor  # [S, S, Q]
    row_mask: torch.Tensor   # [S, R] 1.0 on valid rows
    rows_pad: int
    cols_pad: int
    halo_pad: int
    dia_pad: int             # max |offset| when DIA
    dia_offsets: tuple       # union of diagonal offsets (K,)
    bd_offsets: tuple        # plane block offsets (P,)
    bd_padb: int             # max |block offset|
    bd_ba: int               # the JAX package's VMEM block; sets A_pad only
    wl_wr: int               # windowed-ELL window height (128-blocks)
    wl_ba: int               # windowed-ELL tile (128-row blocks)
    on_format: str           # "ell"|"dia"|"bdia"|"well"|"wellt"|"bell"
    embed_kind: str          # "none" | "cols" | "rows"
    on_rows_pad: int         # row space of the packed on block
    has_t: bool              # transpose path available
    global_num_rows: int
    global_num_cols: int
    comm: Optional[object] = None   # DeviceComm across controllers

    @property
    def n_shards(self) -> int:
        """The shards this device holds: every shard, or one controller's
        one shard when ``comm`` is set."""
        return self.on_cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.on_vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.on_vals.dtype


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _block_anchors(firsts: np.ndarray, space: int):
    """Block-aligned anchors: coarse 128-block k maps whole to a distinct
    fine 128-block bm(k) near its consumers, lanes preserved."""
    n = len(firsts)
    K = -(-n // 128)
    SB = space // 128
    assert K <= SB, (K, SB)
    want = np.array([int(firsts[128 * k:128 * (k + 1)].min()) // 128
                     for k in range(K)], dtype=np.int64)
    bm = np.empty(K, dtype=np.int64)
    prev = -1
    for k in range(K):
        prev = max(prev + 1, int(want[k]))
        bm[k] = prev
    # fix tail overflow: strictly increasing and within SB
    for k in range(K - 1, -1, -1):
        cap = SB - (K - k)
        if bm[k] > cap:
            bm[k] = cap
        else:
            break
    anchor = bm[np.arange(n) // 128] * 128 + np.arange(n) % 128
    return anchor, bm


def _remap_cols(blk: CSRMatrix, anchor: np.ndarray, space: int) -> CSRMatrix:
    """On_proc block with columns moved to their anchor slots."""
    out = CSRMatrix(blk.n_rows, space, blk.indptr.copy(),
                    anchor[blk.indices].astype(np.int64), blk.data.copy())
    return out.sort()


def _remap_rows(blk: CSRMatrix, anchor: np.ndarray,
                space: int) -> CSRMatrix:
    """On_proc block with rows moved to their anchor slots."""
    row_nnz = np.diff(blk.indptr)
    counts = np.zeros(space, dtype=np.int64)
    counts[anchor[:blk.n_rows]] = row_nnz
    indptr = np.concatenate(([0], np.cumsum(counts)))
    indices = np.zeros(blk.nnz, dtype=np.int64)
    data = np.zeros(blk.nnz, dtype=np.float64)
    if blk.nnz:
        erows = np.repeat(np.arange(blk.n_rows), row_nnz)
        pos = np.arange(blk.nnz) - np.repeat(blk.indptr[:-1], row_nnz)
        dest = indptr[anchor[erows]] + pos
        indices[dest] = blk.indices
        data[dest] = blk.data
    return CSRMatrix(space, blk.n_cols, indptr, indices, data)


def _firsts(first_cols: np.ndarray, nonempty: np.ndarray,
            spread: int) -> np.ndarray:
    """Preferred anchor per item: its first neighbour, or an even spread
    for items without one."""
    firsts = np.zeros(len(nonempty), dtype=np.int64)
    firsts[nonempty] = first_cols
    firsts[~nonempty] = np.nonzero(~nonempty)[0] * spread
    return firsts


def _max_row_nnz(blocks) -> int:
    return max((int(np.diff(b.indptr).max()) if b.nnz else 0)
               for b in blocks)


def _transfer_bytes(fmt: str, itemsize: int, *dims: int) -> int:
    """Bytes of the packed arrays that one apply streams in the port's
    layout (x and the output cost every format about alike and are left
    out): ``ell`` (W, R): int64 cols and values; ``well`` (W, R_w, T):
    int32 window-relative cols, values, window starts; ``wellt`` (T, Kp):
    int32 meta, values, slot window bases; ``bell`` (W_b, A128): int8 lane
    ids, values, int32 source block ids.

    It counts the padded layout, though the BELL and sorted-scatter kernels
    read only the real slots and entries (``bl_cnt``, ``wl_cnt``), and the
    windowed-ELL kernel, like them, reads less than the count says: only
    the real entries, from the sliced copy (``well_slices``). Counted
    by real slots, BELL would undercut windowed ELL on the 128^3 level-0 P
    (``PERF.md``) and flip that pick; a rule that ranks by what each kernel
    reads should rest on times measured on the card (ROADMAP Queue 1 item
    7), so the padded count, and every pick it makes, stays."""
    b = itemsize
    if fmt == "ell":
        W, R = dims
        return W * R * (8 + b)
    if fmt == "well":
        W, R_w, T = dims
        return W * R_w * (4 + b) + 4 * T
    if fmt == "wellt":
        T, Kp = dims
        return T * Kp * LANE * (4 + b) + 4 * T * Kp
    W_b, A128 = dims
    return W_b * A128 * LANE * (1 + b) + 4 * W_b * A128


def packed_bytes(M: DeviceParCSR) -> int:
    """Bytes of the packed on-block arrays of ``M``, over all shards: for
    the formats the rule ranks, ``_transfer_bytes`` of the packed shape;
    for DIA its diagonals, for BDIA its planes and the ELL rest."""
    S, b = M.n_shards, M.on_vals.element_size()
    if M.on_format == "ell":
        return S * _transfer_bytes("ell", b, *M.on_vals.shape[1:])
    if M.on_format == "well":
        return S * _transfer_bytes("well", b, *M.on_vals.shape[1:],
                                   M.wl_ws.shape[1])
    if M.on_format == "wellt":
        T, KL = M.on_vals.shape[1:]
        return S * _transfer_bytes("wellt", b, T, KL // LANE)
    if M.on_format == "bell":
        return S * _transfer_bytes("bell", b, *M.bl_vals.shape[1:3])
    arrays = ((M.dia_vals,) if M.on_format == "dia" else
              (M.bd_idx, M.bd_vals, M.rest_cols, M.rest_vals))
    return sum(t.numel() * t.element_size() for t in arrays)


def bdia_tile_share(M: DeviceParCSR) -> float:
    """Share of a BDIA operator's (plane, row block) tiles that hold a
    nonzero: those its kernel reads."""
    S, P = M.bd_vals.shape[:2]
    return int(M.bd_tptr[:, -1].sum()) / max(
        1, S * P * (M.bd_tptr.shape[1] - 1))


def _gall(tr, obj):
    """``obj`` of every rank (``[obj]`` without a transport); every rank
    runs the same reduction on the list, so all agree on the statistic."""
    return [obj] if tr is None else tr.allgather_obj(obj)


def device_put_matrix(a: ParCSRMatrix, dtype=torch.float64,
                      lane_pad: int = 1,
                      force_format: Optional[str] = None,
                      embed: Optional[str] = None,
                      need_transpose: bool = True,
                      device="cuda", tr=None, comm=None) -> DeviceParCSR:
    """Pack a host ParCSRMatrix into the stacked-shard device plan.

    ``embed`` ("cols" for P, "rows" for P^T) moves a transfer operator's
    coarse axis to fine-aligned 128-block anchors, so the block becomes
    near-banded and formats as DIA/BDIA/BELL; the SpMV then adds one
    row-block gather. ``force_format`` ("ell", "well", "wellt", "bell")
    skips the choice: "well" and "wellt" pack the block without the
    embedding, a forced "bell" packs it with the embedding. ``lane_pad``
    rounds the padded row/col/halo sizes (128 on CUDA, as the TPU does,
    makes the TPU's DIA/BDIA picks). ``tr`` (a ``comm.Transport``): ``a``
    may be a local view, and every statistic is agreed through the
    transport (module docstring). ``comm`` (a ``DeviceComm``): the
    matrix's exchanges run across controllers; ``a`` is then this
    controller's view of its one shard, packed through ``tr``."""
    if force_format not in (None,) + FORMATS:
        raise ValueError(f"force_format={force_format!r}; the port packs "
                         f"{FORMATS} or chooses itself (None)")
    dev = resolve_device(device)
    part = a.partition
    shards = a.shards()
    S = len(shards)         # the leading axis: the shards of this view
    if comm is not None and (tr is None or S != 1
                             or comm.world != part.n_shards):
        raise ValueError(
            f"device_put_matrix: across {comm.world} controllers a matrix "
            f"of {part.n_shards} shards packs one shard a controller "
            f"through a transport, not {S}")
    if tr is None:
        plan: CommPlan = build_comm_plan(a, lane_pad=lane_pad)
    else:
        plan = build_comm_plan_spmd(a, tr, lane_pad=lane_pad)
    npdt = _np_dtype(dtype)
    itemsize = npdt.itemsize

    def gmax(x):
        return max(_gall(tr, x))

    def gcat(xs):
        return [x for rank in _gall(tr, xs) for x in rank]

    R = _round_up(max(1, part.max_local_rows), lane_pad)
    C = _round_up(max(1, part.max_local_cols), lane_pad)
    W_off = gmax(_max_row_nnz([s.off_proc for s in shards]))
    # boundary row count (rows with >= 1 off_proc entry), uniform pad
    B = gmax(max(int(np.count_nonzero(np.diff(s.off_proc.indptr)))
                 for s in shards))
    B = _round_up(B, lane_pad) if B else 0

    embed_kind = "none"
    emb_idx = np.zeros((S, 1), dtype=np.int32)
    emb_mask = np.zeros((S, 1), dtype=np.float64)
    fmt_blocks = [blk.on_proc for blk in shards]
    fmt_R = R
    if (embed == "cols" and R % 128 == 0 and C % 128 == 0
            and -(-part.max_local_cols // 128) <= R // 128):
        # inverse block map: fine 128-block j <- coarse block emb_idx[j]
        embed_kind = "cols"
        emb_idx = np.zeros((S, R // 128), dtype=np.int32)
        emb_mask = np.zeros((S, R // 128), dtype=np.float64)
        new_blocks = []
        for s, blk in enumerate(shards):
            m = blk.on_proc.to_scipy().tocsc()
            ne = np.diff(m.indptr) > 0
            firsts = _firsts(m.indices[m.indptr[:-1][ne]], ne,
                             max(1, R // max(1, blk.on_proc.n_cols)))
            anchor, bm = _block_anchors(firsts, R)
            emb_idx[s, bm] = np.arange(len(bm))
            emb_mask[s, bm] = 1.0
            new_blocks.append(_remap_cols(blk.on_proc, anchor, R))
        fmt_blocks = new_blocks
    elif (embed == "rows" and R % 128 == 0 and C % 128 == 0
            and -(-part.max_local_rows // 128) <= C // 128):
        # forward block map: coarse block k -> fine block emb_idx[k]
        embed_kind, fmt_R = "rows", C
        emb_idx = np.zeros((S, R // 128), dtype=np.int32)
        new_blocks = []
        for s, blk in enumerate(shards):
            bo = blk.on_proc
            ne = np.diff(bo.indptr) > 0
            firsts = _firsts(bo.indices[bo.indptr[:-1][ne]], ne,
                             max(1, C // max(1, bo.n_rows)))
            anchor, bm = _block_anchors(firsts, C)
            emb_idx[s, :len(bm)] = bm
            new_blocks.append(_remap_rows(bo, anchor, C))
        fmt_blocks = new_blocks

    # structural format: DIA when the union of all shards' offset sets is
    # small (one offset list for every shard), else BDIA when its planes
    # carry most entries, else ELL
    fmt = force_format
    bd_spec = []
    if fmt is None:
        shard_offs = gcat([dia_detect(blk, MAX_DIA_OFFSETS)
                           for blk in fmt_blocks])
        union = (np.unique(np.concatenate(shard_offs))
                 if all(o is not None for o in shard_offs) else None)
        if union is not None and len(union) <= MAX_DIA_OFFSETS:
            fmt = "dia"
        else:
            merged = {}
            for planes, counts in gcat([bdia_plane_counts(blk)
                                        for blk in fmt_blocks]):
                for p, c in zip(planes, counts):
                    merged[p] = merged.get(p, 0) + int(c)
            A128 = -(-fmt_R // 128)
            per_plane = max(1, A128 * 128 * (itemsize + 1))
            max_planes = min(MAX_BDIA_PLANES,
                             max(8, BDIA_MEM_CAP // per_plane))
            bd_spec = select_planes(merged, max_planes, A128)
            total = sum(merged.values())
            kept_nnz = sum(merged[p] for p in bd_spec)
            pad_ok = max((abs(d) for d, _ in bd_spec), default=0) <= 256
            fmt = ("bdia" if bd_spec and pad_ok and kept_nnz >= 0.6 * total
                   else "ell")
    if fmt == "ell":
        # the embedding only pays off through DIA/BDIA/BELL
        embed_kind, fmt_R = "none", R
        fmt_blocks = [blk.on_proc for blk in shards]
        emb_idx = np.zeros((S, 1), dtype=np.int32)
        emb_mask = np.zeros((S, 1), dtype=np.float64)
    A128 = -(-fmt_R // 128)

    # transfer formats: a matrix headed for ELL competes with those its
    # shape admits, by the bytes one apply streams; a forced one is packed
    wl_ba, wl_wr, wl_T = WELL_BA, 0, 1
    sw_Kp = bl_Wb = wW = 0
    if force_format == "bell":
        bl_Wb = gmax(max(bell_stats(blk)[0] for blk in fmt_blocks))
    elif force_format in ("well", "wellt") or (force_format is None
                                               and fmt == "ell"):
        auto = force_format is None
        cand = {}
        if auto:
            cand["ell"] = _transfer_bytes(
                "ell", itemsize,
                max(1, gmax(_max_row_nnz([s.on_proc for s in shards]))), R)
        if force_format == "well" or (auto and R >= TRANSFER_MIN):
            stats = gcat([wind_ell_stats(blk.on_proc, R, wl_ba)
                          for blk in shards])
            wW = max(st[0] for st in stats)
            wWR = max(st[1] for st in stats)
            T_w = _round_up(R, wl_ba * LANE) // (wl_ba * LANE)
            if wW > 0 or not auto:
                cand["well"] = _transfer_bytes("well", itemsize, wW,
                                               T_w * wl_ba * LANE, T_w)
        if force_format == "wellt" or (
                auto and part.global_num_rows < part.global_num_cols
                and C >= TRANSFER_MIN):
            statsT = gcat([swellt_stats(blk.on_proc.transpose())
                           for blk in shards])
            sw_T = max(t for t, _ in statsT)
            sw_Kp = max(k for _, k in statsT)
            if sw_Kp > 0 or not auto:
                cand["wellt"] = _transfer_bytes("wellt", itemsize, sw_T,
                                                sw_Kp)
        if auto and part.global_num_rows > part.global_num_cols:
            W_b = gmax(max(bell_stats(blk)[0] for blk in fmt_blocks))
            if W_b > 0 and A128 > 2:
                cand["bell"] = _transfer_bytes("bell", itemsize, W_b, A128)
        fmt = min(cand, key=lambda f: (cand[f], f))
        if fmt == "well":
            wl_wr, wl_T = max(wWR, 8), T_w
        elif fmt == "wellt":
            wl_wr, wl_T = SWELLT_AMAX, sw_T
        elif fmt == "bell":
            bl_Wb = W_b
        if fmt in ("well", "wellt"):
            # well/wellt pack the ORIGINAL blocks; drop any embedding
            embed_kind = "none"
            emb_idx = np.zeros((S, 1), dtype=np.int32)
            emb_mask = np.zeros((S, 1), dtype=np.float64)

    if fmt == "bell":
        bl_src = np.zeros((S, bl_Wb, A128), dtype=np.int32)
        bl_idx = np.zeros((S, bl_Wb, A128, 128), dtype=np.int8)
        bl_vals = np.zeros((S, bl_Wb, A128, 128), dtype=npdt)
        bl_cnt = np.zeros((S, A128), dtype=np.int32)
    else:
        bl_src = np.zeros((S, 0, 1), dtype=np.int32)
        bl_idx = np.zeros((S, 0, 1, 128), dtype=np.int8)
        bl_vals = np.zeros((S, 0, 1, 128), dtype=npdt)
        bl_cnt = np.zeros((S, 1), dtype=np.int32)

    bd_offsets, bd_padb, bd_ba = (), 1, 0
    rest_shards = fmt_blocks
    if fmt == "bdia":
        bd_offsets = tuple(d for d, _ in bd_spec)
        bd_padb = max(1, max(abs(d) for d in bd_offsets))
        Pn = len(bd_spec)
        # the JAX package's TPU block size: it only rounds A_pad here,
        # kept so that the packed planes compare byte for byte
        for cand_ba in (256, 128, 64, 32, 16, 8):
            need = (Pn * cand_ba * 128 * (itemsize + 1)
                    + (cand_ba + 2 * bd_padb) * 128 * itemsize) * 2
            if need <= 32 * 1024 * 1024:
                bd_ba = cand_ba
                break
        A_pad = _round_up(A128, bd_ba) if bd_ba else A128
        bd_idx = np.zeros((S, Pn, A_pad, 128), dtype=np.int8)
        bd_vals = np.zeros((S, Pn, A_pad, 128), dtype=npdt)
        rest_shards = [bdia_split_rest(blk, bd_spec) for blk in fmt_blocks]
        Wr = gmax(_max_row_nnz(rest_shards))
        Br = gmax(max(int(np.count_nonzero(np.diff(r.indptr)))
                      for r in rest_shards))
        Br = _round_up(Br, lane_pad) if Br else 0
    else:
        bd_idx = np.zeros((S, 0, 1, 128), dtype=np.int8)
        bd_vals = np.zeros((S, 0, 1, 128), dtype=npdt)
        bd_tptr = np.zeros((S, 1), dtype=np.int32)
        bd_tplane = np.zeros((S, 0), dtype=np.int32)
        Wr = Br = 0
    rest_rows = np.full((S, Br), fmt_R, dtype=np.int32)
    rest_cols = np.zeros((S, Wr, Br), dtype=np.int32)
    rest_vals = np.zeros((S, Wr, Br), dtype=npdt)

    dia_offsets, dia_pad = (0,), 1
    if fmt == "dia":
        if len(union) == 0:
            union = np.zeros(1, dtype=np.int64)
        dia_offsets = tuple(int(o) for o in union)
        dia_pad = max(1, int(np.abs(union).max()))
        # embedded DIA is forward-only: the ELL copy of the ORIGINAL block
        # serves the transpose path
        W_on = (max(1, gmax(_max_row_nnz([s.on_proc for s in shards])))
                if embed_kind != "none" else 1)
        on_shape = (S, W_on, R)
        dia_vals = np.zeros((S, len(union), fmt_R), dtype=npdt)
    elif fmt == "well":
        # window-relative cols over the tiled row space
        fmt_R = wl_T * wl_ba * LANE
        on_shape = (S, max(1, wW), fmt_R)
        dia_vals = np.zeros((S, 1, 1), dtype=npdt)
    elif fmt == "wellt":
        # sorted-scatter layout of the transposed block over the tiled
        # SOURCE (col) space
        fmt_R = wl_T * LANE
        on_shape = (S, wl_T, max(1, sw_Kp) * LANE)
        dia_vals = np.zeros((S, 1, 1), dtype=npdt)
    else:
        if fmt in ("bdia", "bell") and not need_transpose:
            W_on = 1   # the ELL copy only serves spmv_T
        else:
            W_on = max(1, gmax(_max_row_nnz([s.on_proc for s in shards])))
        on_shape = (S, W_on, R)
        dia_vals = np.zeros((S, 1, fmt_R), dtype=npdt)
    on_cols = np.zeros(on_shape, dtype=np.int32)
    on_vals = np.zeros(on_shape, dtype=npdt)
    pack_ell = ((fmt == "ell" or (fmt in ("bdia", "bell") and need_transpose))
                or (fmt == "dia" and embed_kind != "none"))
    if fmt == "wellt":
        wl_ws = np.zeros((S, wl_T * max(1, sw_Kp)), dtype=np.int32)
        wl_jlo = np.zeros((S, 1, 1), dtype=np.int32)
        wl_cnt = np.zeros_like(wl_ws)
    else:
        wl_cnt = np.zeros((S, 1), dtype=np.int32)
        wl_ws = np.zeros((S, wl_T), dtype=np.int32)
        wl_jlo = np.zeros((S, wl_T if fmt == "well" else 1,
                           on_shape[1] if fmt == "well" else 1),
                          dtype=np.int32)
    wl_jhi = np.zeros_like(wl_jlo)
    wl_perm = np.zeros((S, 1), dtype=np.int16)
    wl_sptr = np.zeros((S, 1), dtype=np.int32)
    wl_crel = np.zeros((S, 1), dtype=np.int16)
    wl_cvals = np.zeros((S, 1), dtype=npdt)

    off_rows = np.full((S, B), R, dtype=np.int32)
    off_cols = np.zeros((S, W_off, B), dtype=np.int32)
    off_vals = np.zeros((S, W_off, B), dtype=npdt)
    row_mask = np.zeros((S, R), dtype=npdt)
    for s, blk in enumerate(shards):
        if fmt == "dia":
            dia_vals[s] = dia_arrays(fmt_blocks[s], union, fmt_R,
                                     dtype=npdt)
        elif fmt == "well":
            (wl_ws[s], on_cols[s], on_vals[s], wl_jlo[s],
             wl_jhi[s]) = wind_ell_arrays(blk.on_proc, R, on_shape[1], wl_wr,
                                          wl_ba, C, dtype=npdt)
        elif fmt == "wellt" and sw_Kp > 0:
            # the TRANSPOSED block: source rows = x domain, targets = rows
            meta, vals, qb = swellt_arrays(blk.on_proc.transpose(), sw_Kp,
                                           dtype=npdt)
            on_cols[s, :len(meta)], on_vals[s, :len(meta)] = meta, vals
            wl_ws[s, :len(qb)] = qb
            wl_cnt[s] = swellt_counts(on_vals[s])
        if pack_ell:
            on_cols[s], on_vals[s] = ell_arrays(blk.on_proc, R, W_on,
                                                dtype=npdt)
        if fmt == "bell":
            bl_src[s], bl_idx[s], bl_vals[s] = bell_arrays(
                fmt_blocks[s], A128, bl_Wb, dtype=npdt)
            bl_cnt[s] = bell_counts(bl_vals[s])
        if fmt == "bdia":
            bd_idx[s], bd_vals[s] = bdia_arrays(fmt_blocks[s], bd_spec,
                                                bd_idx.shape[2], dtype=npdt)
            if Br:
                rest_rows[s], rest_cols[s], rest_vals[s] = \
                    ell_boundary_arrays(rest_shards[s], Wr, Br, fmt_R,
                                        dtype=npdt)
        if B:
            off_rows[s], off_cols[s], off_vals[s] = ell_boundary_arrays(
                blk.off_proc, W_off, B, R, dtype=npdt)
        row_mask[s, :blk.local_num_rows] = 1.0
    if fmt == "bdia":
        bd_tptr, bd_tplane = bdia_tiles(bd_vals, fmt_R)
    if fmt == "well":
        wl_perm, wl_sptr, wl_crel, wl_cvals = well_slices(
            wl_ws, on_cols, on_vals, wl_ba, wl_wr)

    def put(x, dt=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    lng = torch.int64
    # the host-to-card copies: a phase "copy" of the packing's Profiler
    # (``DeviceHierarchy.pack_times``) where one is open
    with nested_phase("copy"):
        return DeviceParCSR(
            # the well/wellt kernels read their int32 layouts as they are
            on_cols=put(on_cols, None if fmt in ("well", "wellt") else lng),
            on_vals=put(on_vals),
            off_rows=put(off_rows, lng), off_cols=put(off_cols, lng),
            off_vals=put(off_vals),
            dia_vals=put(dia_vals),
            dia_off=put(np.asarray(dia_offsets, dtype=np.int32)),
            bd_idx=put(bd_idx), bd_vals=put(bd_vals),
            bd_off=put(np.asarray(bd_offsets, dtype=np.int32)),
            bd_tptr=put(bd_tptr), bd_tplane=put(bd_tplane),
            bl_src=put(bl_src), bl_idx=put(bl_idx), bl_vals=put(bl_vals),
            bl_cnt=put(bl_cnt),
            rest_rows=put(rest_rows, lng), rest_cols=put(rest_cols, lng),
            rest_vals=put(rest_vals),
            emb_idx=put(emb_idx, lng), emb_mask=put(emb_mask.astype(npdt)),
            wl_ws=put(wl_ws), wl_jlo=put(wl_jlo), wl_jhi=put(wl_jhi),
            wl_cnt=put(wl_cnt), wl_perm=put(wl_perm), wl_sptr=put(wl_sptr),
            wl_crel=put(wl_crel), wl_cvals=put(wl_cvals),
            send_idx=put(plan.send_idx, lng),
            send_mask=put(plan.send_mask.astype(npdt)),
            halo_src=put(plan.halo_src, lng),
            slot_to_halo=put(plan.slot_to_halo, lng),
            recv_mask=put(plan.recv_mask.astype(npdt)),
            row_mask=put(row_mask),
            rows_pad=R, cols_pad=C, halo_pad=plan.halo_pad,
            dia_pad=dia_pad, dia_offsets=dia_offsets,
            bd_offsets=bd_offsets, bd_padb=bd_padb, bd_ba=bd_ba,
            wl_wr=wl_wr, wl_ba=wl_ba,
            on_format=fmt, embed_kind=embed_kind, on_rows_pad=fmt_R,
            has_t=not (fmt in ("bdia", "bell") and not need_transpose),
            global_num_rows=part.global_num_rows,
            global_num_cols=part.global_num_cols,
            comm=comm,
        )


# --- vectors -----------------------------------------------------------------

def device_put_vector(x: np.ndarray, bounds: np.ndarray, pad: int,
                      dtype=torch.float64, device="cuda",
                      first_shard: int = 0,
                      n_local: Optional[int] = None) -> torch.Tensor:
    """Host vector -> padded [S_local, pad] device tensor of the shards
    ``[first_shard, first_shard + n_local)`` (default: every shard), whose
    rows ``x`` holds, in order."""
    S = len(bounds) - 1
    n_local = S - first_shard if n_local is None else n_local
    r0 = int(bounds[first_shard])
    if len(x) != int(bounds[first_shard + n_local]) - r0:
        raise ValueError(f"{len(x)} values for the rows of shards "
                         f"[{first_shard}, {first_shard + n_local})")
    out = np.zeros((n_local, pad), dtype=np.float64)
    for i in range(n_local):
        a, b = int(bounds[first_shard + i]), int(bounds[first_shard + i + 1])
        out[i, :b - a] = x[a - r0:b - r0]
    return torch.from_numpy(out).to(resolve_device(device), dtype)


def put_stacked(staged: dict, n_shards: int, device, dtype=None,
                first_shard: int = 0) -> dict:
    """Upload a dict of [S_local, ...] host arrays whose leading axis is
    the shards ``first_shard`` onward of ``n_shards`` (the JAX package's
    placement of each shard on its device; a controller uploads its own
    part of the stack): float arrays in ``dtype``, integer ones as int64."""
    dev = resolve_device(device)
    out = {}
    for k, arr in staged.items():
        arr = np.ascontiguousarray(arr)
        if first_shard + arr.shape[0] > n_shards:
            raise ValueError(f"{k}: shards [{first_shard}, "
                             f"{first_shard + arr.shape[0]}) of {n_shards}")
        t = torch.from_numpy(arr)
        out[k] = t.to(dev, torch.int64 if arr.dtype.kind in "iu" else dtype)
    return out


def put_replicated(x: np.ndarray, device, dtype=None) -> torch.Tensor:
    """A value every shard reads whole (the redundant coarse LU factors,
    par_multilevel.hpp:223-333): one copy on each device."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        resolve_device(device), dtype)


def device_put_vector_local(x_locals, bounds: np.ndarray, pad: int,
                            dtype=torch.float64, device="cuda",
                            first_shard: int = 0) -> torch.Tensor:
    """Per-rank vector placement: ``x_locals`` holds one slice a LOCAL
    shard, from ``first_shard`` on."""
    out = np.zeros((len(x_locals), pad), dtype=np.float64)
    for i, xl in enumerate(x_locals):
        s = first_shard + i
        n = int(bounds[s + 1] - bounds[s])
        if len(xl) != n:
            raise ValueError(f"shard {s}: {len(xl)} values for {n} rows")
        out[i, :n] = xl
    return put_stacked({"v": out}, len(bounds) - 1, device, dtype,
                       first_shard)["v"]


def host_vector(x: torch.Tensor, bounds: np.ndarray,
                first_shard: int = 0) -> np.ndarray:
    """Padded [S_local, pad] tensor of the shards ``first_shard`` onward ->
    their rows as one host vector (every row when it holds every shard)."""
    x = x.detach().cpu().numpy()
    return np.concatenate([
        x[i, :int(bounds[first_shard + i + 1] - bounds[first_shard + i])]
        for i in range(x.shape[0])])


# --- shard-batched operators ---------------------------------------------------

def halo_exchange(A: DeviceParCSR, x: torch.Tensor) -> torch.Tensor:
    """Forward halo exchange: local x [S, C] -> halo values [S, H]
    (ParComm::communicate, core/comm_pkg.hpp:631-652). Across controllers
    the send buffer's rows go to their ranks by ``comm.all_to_all``."""
    send = _take(x, A.send_idx)                      # [S_src, S_dst, Q]
    if A.comm is not None:                           # S_src = 1 a controller
        recv = A.comm.all_to_all(send[0]).reshape(1, -1)
    else:
        recv = send.transpose(0, 1).reshape(A.n_shards, -1)
    return torch.gather(recv, 1, A.halo_src)         # [S_dst, S_src * Q]


def halo_exchange_T(A: DeviceParCSR, halo_vals: torch.Tensor,
                    n_out: int) -> torch.Tensor:
    """Transpose exchange with sum reduction: halo contributions [S, H]
    added back at the owning shard's local cols [S, n_out]
    (ParComm::communicate_T, core/comm_pkg.hpp:756-800)."""
    buf = _take(halo_vals, A.slot_to_halo) * A.recv_mask   # [S_r, S_o, Q]
    if A.comm is not None:
        back = A.comm.all_to_all(buf[0])[None] * A.send_mask
    else:
        back = buf.transpose(0, 1) * A.send_mask           # [S_o, S_r, Q]
    return _scatter_add(n_out, A.send_idx, back)


def halo(A: DeviceParCSR, x: torch.Tensor, T=None) -> torch.Tensor:
    """The halo values of ``x``: through the topology-aware exchange plan
    ``T`` (``comm.tap.DeviceTAP``) when given, else the plain exchange."""
    if T is not None:
        return tap_halo_exchange(T, x)
    return halo_exchange(A, x)


def on_spmv(A: DeviceParCSR, x: torch.Tensor) -> torch.Tensor:
    """b = A_on x (on_proc block only), format-dispatched. An embedded
    transfer operator keeps its coarse axis at fine-aligned anchors:
    'cols' gathers x into the embedded space first, 'rows' compacts the
    embedded result back."""
    S = A.n_shards
    if A.embed_kind == "cols":
        # row-block gather: fine block j <- coarse block emb_idx[j]
        x2 = x.reshape(S, -1, LANE)
        idx = A.emb_idx[:, :, None].expand(-1, -1, LANE)
        x = (torch.gather(x2, 1, idx) * A.emb_mask[:, :, None]).reshape(S,
                                                                        -1)
    if A.on_format == "well":
        return kernels.wind_ell_spmv(A.wl_ws, A.wl_perm, A.wl_sptr,
                                     A.wl_crel, A.wl_cvals, x.contiguous(),
                                     A.wl_ba, A.rows_pad)
    if A.on_format == "wellt":
        return kernels.swellt_spmv_T(A.on_cols, A.on_vals, A.wl_ws,
                                     x.contiguous(), A.rows_pad, A.wl_cnt)
    if A.on_format == "dia":
        out = kernels.dia_spmv(A.dia_offsets, A.dia_off, A.dia_vals,
                               x.contiguous(), A.dia_pad)
    elif A.on_format == "bell":
        out = kernels.bell_spmv(A.bl_src, A.bl_idx, A.bl_vals,
                                x.contiguous(), A.on_rows_pad, A.bl_cnt)
    elif A.on_format == "bdia":
        out = kernels.bdia_spmv(A.bd_offsets, A.bd_off, A.bd_idx, A.bd_vals,
                                x.contiguous(), A.bd_padb, A.on_rows_pad,
                                A.bd_tptr, A.bd_tplane)
        # entries of the planes left out go through the compacted gather
        out = out + off_spmv(A.rest_rows, A.rest_cols, A.rest_vals, x,
                             A.on_rows_pad)
    else:
        return ell_spmv(A.on_cols, A.on_vals, x)
    if A.embed_kind == "rows":
        # compact: coarse block k <- fine block emb_idx[k]
        o2 = out.reshape(S, -1, LANE)
        idx = A.emb_idx[:, :, None].expand(-1, -1, LANE)
        out = torch.gather(o2, 1, idx).reshape(S, -1) * A.row_mask
    return out


def on_spmv_T(A: DeviceParCSR, x: torch.Tensor) -> torch.Tensor:
    if A.on_format == "dia" and A.embed_kind == "none":
        return dia_spmv_T(A.dia_offsets, A.dia_vals, x, A.cols_pad,
                          A.dia_pad)
    if A.on_format == "well":
        # absolute cols over the tiled row space
        cols = wind_ell_cols(A.wl_ws, A.on_cols, A.wl_ba)
        xp = F.pad(x, (0, A.on_vals.shape[2] - x.shape[1]))
        return ell_spmv_T(cols, A.on_vals, xp, A.cols_pad)
    if A.on_format == "wellt":
        # the packed arrays ARE the transpose: spmv_T is a forward gather
        return swellt_spmv(A.on_cols, A.on_vals, A.wl_ws, x, A.cols_pad)
    if not A.has_t:
        raise ValueError(
            "matrix was packed with need_transpose=False; rebuild with "
            "device_put_matrix(..., need_transpose=True) for spmv_T")
    # bdia / embedded blocks keep the original ELL for the transpose path
    return ell_spmv_T(A.on_cols, A.on_vals, x, A.cols_pad)


def spmv(A: DeviceParCSR, x: torch.Tensor, T=None) -> torch.Tensor:
    """b = A x; x [S, C] local cols -> b [S, R] local rows
    (ParCSRMatrix::mult, par_spmv.cpp:25-59), the halo through ``halo``
    (the topology-aware plan ``T`` when given: par_spmv.cpp:61-89)."""
    hv = halo(A, x, T)
    return on_spmv(A, x) + off_spmv(A.off_rows, A.off_cols, A.off_vals,
                                    hv, A.rows_pad)


# the side stream of each card that ``spmv_overlap`` runs the exchange on
_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    stream = _SIDE_STREAMS.get(device)
    if stream is None:
        stream = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def spmv_overlap(A: DeviceParCSR, x: torch.Tensor, T=None) -> torch.Tensor:
    """``spmv(A, x)`` with the halo exchange overlapped with the on-block
    product, the order XLA's scheduler gives the JAX package's
    ``spmv_shard`` (par_spmv.cpp's Isend / Irecv, local product, Waitall).

    On the card the exchange (gather, transpose, gather) runs on a side
    stream, made once per device, which first waits on an event recorded
    on the current stream (so ``x`` is ready); ``on_spmv`` runs on the
    current stream, which waits on the side stream's event before the
    off-block product. The same kernels sum in the same order as
    ``spmv``, so the result is bit-equal to it. On CPU tensors it is
    ``spmv``'s order. The exchange across controllers (``A.comm``) and the
    topology-aware one (``T``) are not overlapped: both raise."""
    if A.comm is not None or T is not None:
        raise NotImplementedError(
            "spmv_overlap: the exchange across controllers and the "
            "topology-aware exchange are not overlapped; use spmv")
    if x.device.type != "cuda":
        return spmv(A, x)
    main = torch.cuda.current_stream(x.device)
    side = _side_stream(x.device)
    side.wait_event(main.record_event())
    with torch.cuda.stream(side):
        hv = halo_exchange(A, x)
        done = side.record_event()
    b = on_spmv(A, x)
    main.wait_event(done)
    # the halo was allocated on the side stream: keep its block from the
    # next exchange until the off-block product has read it
    hv.record_stream(main)
    return b + off_spmv(A.off_rows, A.off_cols, A.off_vals, hv, A.rows_pad)


def spmv_T(A: DeviceParCSR, x: torch.Tensor, T=None) -> torch.Tensor:
    """b = A^T x; x [S, R] local rows -> b [S, C] local cols
    (par_spmv.cpp:157-209), the halo contributions summed back through
    ``T`` when given."""
    halo_contrib = off_spmv_T(A.off_rows, A.off_cols, A.off_vals, x,
                              A.halo_pad)
    if T is not None:
        back = tap_halo_exchange_T(T, halo_contrib, A.cols_pad)
    else:
        back = halo_exchange_T(A, halo_contrib, A.cols_pad)
    return on_spmv_T(A, x) + back


def residual(A: DeviceParCSR, x: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """r = b - A x (par_spmv.cpp:211-280)."""
    return b - spmv(A, x)


def all_shards(v: torch.Tensor, comm=None) -> torch.Tensor:
    """A per-shard ``[S_local, ...]`` value of every shard, ``[S, ...]`` in
    shard order: ``v`` itself on one device, every controller's gathered
    across controllers (one shard each, in rank order)."""
    if comm is None:
        return v
    return comm.all_gather(v).reshape((-1,) + tuple(v.shape[1:]))


def shard_dots(x: torch.Tensor, y: torch.Tensor, comm=None) -> torch.Tensor:
    """Each shard's local inner product, [S] in shard order (gathered
    across controllers by ``comm``): what the JAX package's shards reduce
    with ``psum`` (``dot``) or in shard order (the sequential and partial
    inner products of ``krylov.bicgstab``)."""
    return all_shards((x * y).sum(dim=1), comm)


def dot(x: torch.Tensor, y: torch.Tensor, comm=None) -> torch.Tensor:
    """Global inner product (par_vector.cpp:101): the shards' local dots,
    summed in one reduction of the ``[S]`` vector (the same on every
    controller across controllers)."""
    return shard_dots(x, y, comm).sum()


def norm(x: torch.Tensor, comm=None) -> torch.Tensor:
    return torch.sqrt(dot(x, x, comm))
