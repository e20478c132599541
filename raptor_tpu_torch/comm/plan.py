"""Static halo-exchange plans (copy of raptor_tpu.comm.plan).

Equivalent of the reference's ``ParComm`` construction
(core/comm_pkg.hpp:302-986): for every shard, which remote columns its
off_proc block references, who owns them, and the send/recv schedule, as
static index arrays:

- ``send_idx[s, d, q]``: the q-th local column shard ``s`` sends to ``d``;
- ``halo_src[s, h]``: flat (src*Q + q) receive slot holding halo column h;
- ``slot_to_halo[s, d, q]`` + masks: the inverse, for the transpose
  (reduction) exchange.

On stacked shards the exchange is a gather, a transpose of the
``[S_src, S_dst, Q]`` send buffer and a gather (``device.par``); across
controllers, one shard each, the transpose is an all-to-all of a
controller's ``[S_dst, Q]`` row. ``build_comm_plan`` sees every shard;
``build_comm_plan_spmd`` builds the same plan rank-locally over a
transport, for the view's shards.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class CommPlan:
    """Stacked-over-shards static halo exchange schedule."""

    n_shards: int
    slot: int              # Q: max entries sent between any shard pair
    halo_pad: int          # H: padded halo size (max over shards)
    send_idx: np.ndarray   # [S, S, Q] int32, local col ids, pad->0
    send_mask: np.ndarray  # [S, S, Q] float, 1 where send_idx valid
    halo_src: np.ndarray   # [S, H] int32, flat recv slot per halo col, pad->0
    halo_mask: np.ndarray  # [S, H] float
    slot_to_halo: np.ndarray  # [S, S, Q] int32, halo pos per recv slot
    recv_mask: np.ndarray  # [S, S, Q] float, 1 where recv slot valid
    n_halo: np.ndarray     # [S] true halo sizes


def build_comm_plan(a: ParCSRMatrix, lane_pad: int = 1) -> CommPlan:
    """Build the halo exchange plan for matrix ``a``'s off_proc columns."""
    part = a.partition
    S = part.n_shards
    shards = a.shards()

    # per (owner, requester) pair: owner-local col indices requested, in
    # the requester's halo (= global col) order
    pair_cols: List[List[np.ndarray]] = [[None] * S for _ in range(S)]
    pair_halo_pos: List[List[np.ndarray]] = [[None] * S for _ in range(S)]
    for r in range(S):
        cmap = shards[r].off_proc_column_map
        owners = part.col_owner(cmap)
        for o in np.unique(owners):
            sel = owners == o
            pair_cols[int(o)][r] = (cmap[sel] - part.col_bounds[int(o)]
                                    ).astype(np.int32)
            pair_halo_pos[int(o)][r] = np.nonzero(sel)[0].astype(np.int32)

    cnt = np.zeros((S, S), dtype=np.int64)
    for o in range(S):
        for r in range(S):
            if pair_cols[o][r] is not None:
                cnt[o, r] = len(pair_cols[o][r])
    Q = max(1, int(cnt.max()))
    H = max(1, _round_up(max(1, max(len(s.off_proc_column_map)
                                    for s in shards)), lane_pad))

    send_idx = np.zeros((S, S, Q), dtype=np.int32)
    send_mask = np.zeros((S, S, Q), dtype=np.float64)
    halo_src = np.zeros((S, H), dtype=np.int32)
    halo_mask = np.zeros((S, H), dtype=np.float64)
    slot_to_halo = np.zeros((S, S, Q), dtype=np.int32)
    recv_mask = np.zeros((S, S, Q), dtype=np.float64)
    n_halo = np.array([len(s.off_proc_column_map) for s in shards],
                      dtype=np.int64)

    for o in range(S):
        for r in range(S):
            c = int(cnt[o, r])
            if c == 0:
                continue
            send_idx[o, r, :c] = pair_cols[o][r]
            send_mask[o, r, :c] = 1.0
            hpos = pair_halo_pos[o][r]
            halo_src[r, hpos] = o * Q + np.arange(c, dtype=np.int32)
            halo_mask[r, hpos] = 1.0
            slot_to_halo[r, o, :c] = hpos
            recv_mask[r, o, :c] = 1.0

    return CommPlan(S, Q, H, send_idx, send_mask, halo_src, halo_mask,
                    slot_to_halo, recv_mask, n_halo)


def build_comm_plan_spmd(a: ParCSRMatrix, tr, lane_pad: int = 1) -> CommPlan:
    """Rank-local plan build over a ``Transport``: the init_par_comm
    handshake (core/comm_pkg.hpp:432-495). Each rank derives its receive
    schedule from its own off_proc column maps, learns its send schedule
    from an all-to-all of wanted-column lists, and agrees on the global
    pads (Q, H) by an allgather of local maxima. The arrays' leading axis
    covers only the LOCAL shards; with every shard local the plan equals
    ``build_comm_plan``'s."""
    part = a.partition
    S = part.n_shards
    shards = a.shards()
    SL = len(shards)
    fs = a.first_shard

    cmaps = [np.asarray(blk.off_proc_column_map) for blk in shards]
    # requester side: what each of my shards wants from every owner
    req, halo_pos = [], []
    for m in cmaps:
        owners = part.col_owner(m)
        per_o = [np.zeros(0, dtype=np.int64)] * S
        pos_o = [np.zeros(0, dtype=np.int64)] * S
        for o in np.unique(owners):
            sel = owners == o
            per_o[int(o)] = m[sel]
            pos_o[int(o)] = np.nonzero(sel)[0]
        req.append(per_o)
        halo_pos.append(pos_o)
    got = tr.alltoall_obj(req)   # got[i][r]: cols requester r wants of me

    q_loc = max([1] + [len(g) for gi in got for g in gi]
                + [len(x) for ri in req for x in ri])
    h_loc = max([1] + [len(m) for m in cmaps])
    Q = int(max(tr.allgather_obj(q_loc)))
    H = _round_up(int(max(tr.allgather_obj(h_loc))), lane_pad)

    send_idx = np.zeros((SL, S, Q), dtype=np.int32)
    send_mask = np.zeros((SL, S, Q), dtype=np.float64)
    halo_src = np.zeros((SL, H), dtype=np.int32)
    halo_mask = np.zeros((SL, H), dtype=np.float64)
    slot_to_halo = np.zeros((SL, S, Q), dtype=np.int32)
    recv_mask = np.zeros((SL, S, Q), dtype=np.float64)
    n_halo = np.array([len(m) for m in cmaps], dtype=np.int64)

    for i in range(SL):
        c0 = int(part.col_bounds[fs + i])
        for r in range(S):
            cr = len(got[i][r])
            if cr:
                send_idx[i, r, :cr] = np.asarray(got[i][r],
                                                 dtype=np.int64) - c0
                send_mask[i, r, :cr] = 1.0
        for o in range(S):
            hpos = halo_pos[i][o]
            c = len(hpos)
            if c:
                halo_src[i, hpos] = o * Q + np.arange(c, dtype=np.int32)
                halo_mask[i, hpos] = 1.0
                slot_to_halo[i, o, :c] = hpos
                recv_mask[i, o, :c] = 1.0

    return CommPlan(S, Q, H, send_idx, send_mask, halo_src, halo_mask,
                    slot_to_halo, recv_mask, n_halo)
