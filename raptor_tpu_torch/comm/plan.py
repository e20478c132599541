"""Static halo-exchange plans (copy of raptor_tpu.comm.plan, in-process
construction only).

Equivalent of the reference's ``ParComm`` construction
(core/comm_pkg.hpp:302-986): for every shard, which remote columns its
off_proc block references, who owns them, and the send/recv schedule, as
static index arrays:

- ``send_idx[s, d, q]``: the q-th local column shard ``s`` sends to ``d``;
- ``halo_src[s, h]``: flat (src*Q + q) receive slot holding halo column h;
- ``slot_to_halo[s, d, q]`` + masks: the inverse, for the transpose
  (reduction) exchange.

On stacked shards the exchange is a gather, a transpose of the
``[S_src, S_dst, Q]`` send buffer and a gather (``device.par``).
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
