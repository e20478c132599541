"""Topology-aware (node-aware) halo exchange, the TAPComm equivalent (copy
of raptor_tpu.comm.tap).

The reference's TAPComm (core/comm_pkg.hpp:1020-1839, core/tap_comm.cpp,
arXiv:1612.08060) decomposes the halo exchange into intra-node steps and
one inter-node step, deduplicating values per node pair. The shards are
laid out as ``S = H * L``: shard ``s`` is local shard ``s % L`` of host
``s // L`` (``device.par.make_mesh2``).

Forward exchange = 4 static steps (3-step TAPComm analog):
  L: intra-host all_to_all for same-host halo values        (local_L)
  S: owners send inter-host values to the pair gateway       (local_S)
  G: one all_to_all across the host axis, gateway-to-gateway (global)
  R: gateways redistribute to the requesting shards          (local_R)

Each (src_host A, dst_host B) pair's column set is deduplicated (a column
needed by several shards of B crosses hosts once) and handled by the
gateway with local index (A + B) % L on both sides, spreading host-pair
traffic over a host's shards. The transpose exchange reverses each step
with sum reductions (DuplicateData::communicate_T semantics,
core/comm_data.hpp:1064-1424).

The plan (``TAPPlanHost``) is host numpy, byte-equal to the JAX
package's. With every shard on one card the stacked ``[S, ...]`` arrays
hold all shards, and an all_to_all over an axis of the (host, local)
layout is a transpose of the stacked buffer (``_a2a_local``,
``_a2a_host``), so one exchange is a few gathers, transposes and
scatter-adds over every shard at once. Across controllers (one shard
each, ``comm.bootstrap.DeviceComm``) every controller holds the same
global plan and uploads its shard's row of it; the plan carries the
comm's (local, host) sub-groups (``DeviceComm.mesh2``), and each
transpose becomes an all-to-all over one of them. The gathers and
scatter-adds, and so the arithmetic, are the same on both routes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.device.formats import _scatter_add, _take

@dataclasses.dataclass
class TAPPlanHost:
    """Host-side numpy plan (stacked over S = H*L shards)."""
    H: int
    L: int
    # L step (intra-host direct)
    sendL_idx: np.ndarray    # [S, L, QL]
    sendL_mask: np.ndarray
    haloL_src: np.ndarray    # [S, Hpad] flat L*QL slot
    haloL_mask: np.ndarray
    slotL_to_halo: np.ndarray  # [S, L, QL]
    recvL_mask: np.ndarray
    # S step (owner -> gateway, intra-host)
    sendS_idx: np.ndarray    # [S, L, QS] owner-local col ids
    sendS_mask: np.ndarray
    # G step (gateway -> gateway, across hosts)
    gpack_idx: np.ndarray    # [S, H, QG] flat L*QS index into S-recv
    gpack_mask: np.ndarray
    # R step (gateway -> requester, intra-host)
    rpack_idx: np.ndarray    # [S, L, QR] flat H*QG index into G-recv
    rpack_mask: np.ndarray
    haloR_src: np.ndarray    # [S, Hpad] flat L*QR slot
    haloR_mask: np.ndarray
    slotR_to_halo: np.ndarray  # [S, L, QR] halo position per R-recv slot
    recvR_mask: np.ndarray
    # reverse-direction scatter targets
    revR_target: np.ndarray  # [S, L, QR] flat H*QG slot fed by this R slot
    revG_target: np.ndarray  # [S, H, QG] flat L*QS slot fed by this G slot
    halo_pad: int
    # diagnostics
    dcn_values: int          # total deduplicated values crossing hosts
    dcn_values_plain: int    # without dedup (plain ParComm equivalent)


def build_tap_plan(a: ParCSRMatrix, H: int, L: int,
                   lane_pad: int = 1) -> TAPPlanHost:
    col_maps = [np.asarray(blk.off_proc_column_map) for blk in a.shards()]
    return build_tap_plan_from_maps(col_maps, a.partition, H, L, lane_pad)


def build_tap_plan_from_maps(col_maps, part, H: int, L: int,
                             lane_pad: int = 1) -> TAPPlanHost:
    """Build the TAP schedule from each shard's off-proc column map only
    (the plan needs no matrix values). This is the multi-controller
    entry: each controller allgathers its local shards' (small) halo
    column maps over the setup transport and then deterministically
    builds the identical global plan — the same construction TAPComm
    does collectively over MPI (core/tap_comm.cpp:24-120)."""
    S = part.n_shards
    if S != H * L or len(col_maps) != S:
        raise ValueError(f"{S} shards and {len(col_maps)} column maps on a "
                         f"{H} x {L} layout")

    def host_of(s):
        return s // L

    def local_of(s):
        return s % L

    def gateway(A, B):
        return (A + B) % L

    # --- classify halo columns per requester ---------------------------------
    # same-host pairs -> L plan; cross-host -> U[A][B] dedup sets
    pairL_cols = {}       # (owner, req) -> owner-local col ids (halo order)
    pairL_hpos = {}
    U = {}                # (A, B) -> sorted unique global col list
    req_remote = {}       # (req, A) -> (global cols, halo positions)
    for r in range(S):
        cmap = col_maps[r]
        owners = part.col_owner(cmap)
        B = host_of(r)
        for o in np.unique(owners):
            sel = owners == o
            cols = cmap[sel]
            hpos = np.nonzero(sel)[0]
            A = host_of(int(o))
            if A == B:
                pairL_cols[(int(o), r)] = (
                    cols - part.col_bounds[int(o)]).astype(np.int64)
                pairL_hpos[(int(o), r)] = hpos
            else:
                key = (A, B)
                U.setdefault(key, set()).update(cols.tolist())
                g, p = req_remote.setdefault((r, A), ([], []))
                g.extend(cols.tolist())
                p.extend(hpos.tolist())

    U = {k: np.array(sorted(v), dtype=np.int64) for k, v in U.items()}
    dcn_values = sum(len(v) for v in U.values())
    dcn_plain = sum(len(g) for (r, A), (g, p) in req_remote.items())

    Hpad = max(1, max(len(c) for c in col_maps))
    Hpad = ((Hpad + lane_pad - 1) // lane_pad) * lane_pad

    # --- L step arrays ---------------------------------------------------------
    cntL = np.zeros((S, S), dtype=np.int64)
    for (o, r), cols in pairL_cols.items():
        cntL[o, r] = len(cols)
    QL = max(1, int(cntL.max()))
    sendL_idx = np.zeros((S, L, QL), dtype=np.int32)
    sendL_mask = np.zeros((S, L, QL))
    haloL_src = np.zeros((S, Hpad), dtype=np.int32)
    haloL_mask = np.zeros((S, Hpad))
    slotL_to_halo = np.zeros((S, L, QL), dtype=np.int32)
    recvL_mask = np.zeros((S, L, QL))
    for (o, r), cols in pairL_cols.items():
        lo, lr = local_of(o), local_of(r)
        c = len(cols)
        sendL_idx[o, lr, :c] = cols
        sendL_mask[o, lr, :c] = 1.0
        hpos = pairL_hpos[(o, r)]
        haloL_src[r, hpos] = lo * QL + np.arange(c)
        haloL_mask[r, hpos] = 1.0
        slotL_to_halo[r, lo, :c] = hpos
        recvL_mask[r, lo, :c] = 1.0

    # --- S step: owner -> gateway ------------------------------------------------
    # owner shard o (host A) sends, for each pair (A,B) with gateway g,
    # the values of its own columns in U[A,B], ordered by (B, col).
    send_lists = {}    # (o, g_local) -> list of (owner-local col, B, k)
    for (A, B), cols in U.items():
        g = gateway(A, B)
        owners = part.col_owner(cols)
        for k, (gc, o) in enumerate(zip(cols, owners)):
            o = int(o)
            send_lists.setdefault((o, g), []).append(
                (int(gc - part.col_bounds[o]), B, k))
    QS = max(1, max((len(v) for v in send_lists.values()), default=1))
    sendS_idx = np.zeros((S, L, QS), dtype=np.int32)
    sendS_mask = np.zeros((S, L, QS))
    # gateway-side: locate each (A,B,k) entry in the gateway's S-recv buffer
    entry_slot = {}    # (A, B, k) -> (gateway shard, flat L*QS index)
    for (o, g), lst in sorted(send_lists.items()):
        A = host_of(o)
        lo = local_of(o)
        gshard = A * L + g
        for q, (cloc, B, k) in enumerate(lst):
            sendS_idx[o, g, q] = cloc
            sendS_mask[o, g, q] = 1.0
            entry_slot[(A, B, k)] = (gshard, lo * QS + q)

    # --- G step: gateway -> gateway ------------------------------------------------
    QG = max(1, max((len(v) for v in U.values()), default=1))
    gpack_idx = np.zeros((S, H, QG), dtype=np.int32)
    gpack_mask = np.zeros((S, H, QG))
    revG_target = np.zeros((S, H, QG), dtype=np.int32)
    for (A, B), cols in U.items():
        g = gateway(A, B)
        gshard = A * L + g
        for k in range(len(cols)):
            gs, flat = entry_slot[(A, B, k)]
            assert gs == gshard
            gpack_idx[gshard, B, k] = flat
            gpack_mask[gshard, B, k] = 1.0
            revG_target[gshard, B, k] = flat

    # --- R step: receiving gateway -> requesters -----------------------------------
    # receiving gateway (B, gateway(A,B)) holds G-recv [H, QG];
    # U[A,B][k] lives at flat A*QG + k.
    rsend_lists = {}   # (gshard_recv, req_local) -> list of (A, k, halo_pos)
    for (r, A), (gcols, hpos) in req_remote.items():
        B = host_of(r)
        g = gateway(A, B)
        gshard = B * L + g
        cols_u = U[(A, B)]
        ks = np.searchsorted(cols_u, np.array(gcols))
        for k, hp in zip(ks, hpos):
            rsend_lists.setdefault((gshard, local_of(r)), []).append(
                (A, int(k), hp))
    QR = max(1, max((len(v) for v in rsend_lists.values()), default=1))
    rpack_idx = np.zeros((S, L, QR), dtype=np.int32)
    rpack_mask = np.zeros((S, L, QR))
    haloR_src = np.zeros((S, Hpad), dtype=np.int32)
    haloR_mask = np.zeros((S, Hpad))
    slotR_to_halo = np.zeros((S, L, QR), dtype=np.int32)
    recvR_mask = np.zeros((S, L, QR))
    revR_target = np.zeros((S, L, QR), dtype=np.int32)
    for (gshard, lr), lst in sorted(rsend_lists.items()):
        B = host_of(gshard)
        gl = local_of(gshard)
        r = B * L + lr
        for q, (A, k, hp) in enumerate(lst):
            rpack_idx[gshard, lr, q] = A * QG + k
            rpack_mask[gshard, lr, q] = 1.0
            # requester r: R-recv [L, QR], slot (gl, q)
            haloR_src[r, hp] = gl * QR + q
            haloR_mask[r, hp] = 1.0
            slotR_to_halo[r, gl, q] = hp
            recvR_mask[r, gl, q] = 1.0
            revR_target[gshard, lr, q] = A * QG + k

    return TAPPlanHost(
        H=H, L=L,
        sendL_idx=sendL_idx, sendL_mask=sendL_mask,
        haloL_src=haloL_src, haloL_mask=haloL_mask,
        slotL_to_halo=slotL_to_halo, recvL_mask=recvL_mask,
        sendS_idx=sendS_idx, sendS_mask=sendS_mask,
        gpack_idx=gpack_idx, gpack_mask=gpack_mask,
        rpack_idx=rpack_idx, rpack_mask=rpack_mask,
        haloR_src=haloR_src, haloR_mask=haloR_mask,
        slotR_to_halo=slotR_to_halo, recvR_mask=recvR_mask,
        revR_target=revR_target, revG_target=revG_target,
        halo_pad=Hpad, dcn_values=dcn_values, dcn_values_plain=dcn_plain)


# --- device plan -----------------------------------------------------------

_TAP_DATA = ["sendL_idx", "sendL_mask", "haloL_src", "haloL_mask",
             "slotL_to_halo", "recvL_mask", "sendS_idx", "sendS_mask",
             "gpack_idx", "gpack_mask", "rpack_idx", "rpack_mask",
             "haloR_src", "haloR_mask", "slotR_to_halo", "recvR_mask",
             "revR_target", "revG_target"]


@dataclasses.dataclass
class DeviceTAP:
    """The plan's arrays as stacked ``[S, ...]`` tensors on one device:
    the masks in the hierarchy's dtype, the indices int64 (the port's
    gather index type, as ``DeviceParCSR.send_idx``). Across controllers
    ``S`` is 1 and ``sub`` is the comm's (local, host) sub-groups;
    ``None`` when every shard is on this device."""

    sendL_idx: torch.Tensor
    sendL_mask: torch.Tensor
    haloL_src: torch.Tensor
    haloL_mask: torch.Tensor
    slotL_to_halo: torch.Tensor
    recvL_mask: torch.Tensor
    sendS_idx: torch.Tensor
    sendS_mask: torch.Tensor
    gpack_idx: torch.Tensor
    gpack_mask: torch.Tensor
    rpack_idx: torch.Tensor
    rpack_mask: torch.Tensor
    haloR_src: torch.Tensor
    haloR_mask: torch.Tensor
    slotR_to_halo: torch.Tensor
    recvR_mask: torch.Tensor
    revR_target: torch.Tensor
    revG_target: torch.Tensor
    H: int
    L: int
    QL: int
    QS: int
    QG: int
    QR: int
    halo_pad: int
    sub: Optional[tuple] = None


def device_put_tap(plan: TAPPlanHost, dtype: torch.dtype,
                   device: torch.device, first_shard: int = 0,
                   n_local: int = None, comm=None) -> DeviceTAP:
    """The plan on ``device``, which the caller has resolved (as
    ``device.par.resolve_device`` does for a hierarchy): every shard's
    rows, or with ``comm`` (a ``DeviceComm``, one shard per controller)
    the row of shard ``first_shard``, which must be the controller's
    rank, with the comm's (local, host) sub-groups. Every controller
    builds the same global plan (from the allgathered column maps:
    ``build_tap_plan_from_maps``). Without a comm the exchange transposes
    the stacked buffer, so a view of fewer shards raises."""
    S = plan.H * plan.L
    n_local = S - first_shard if n_local is None else n_local
    sub = None
    if comm is not None:
        if n_local != 1 or first_shard != comm.rank or comm.world != S:
            raise ValueError(
                f"device_put_tap: rank {comm.rank} of {comm.world} "
                f"controllers holds shards [{first_shard}, "
                f"{first_shard + n_local}) of {S}; one shard a "
                f"controller, its own")
        sub = comm.mesh2(plan.H, plan.L)
    elif first_shard != 0 or n_local != S:
        raise ValueError(
            f"device_put_tap: a view of shards [{first_shard}, "
            f"{first_shard + n_local}) of {S} exchanges across "
            f"controllers: pass their comm (comm.bootstrap.init)")
    rows = slice(first_shard, first_shard + n_local)

    def conv(x):
        x = np.ascontiguousarray(np.asarray(x)[rows])
        if x.dtype.kind == "i":
            return torch.from_numpy(x.astype(np.int64)).to(device)
        return torch.from_numpy(x).to(device, dtype)

    return DeviceTAP(
        **{f: conv(getattr(plan, f)) for f in _TAP_DATA},
        H=plan.H, L=plan.L, QL=plan.sendL_idx.shape[-1],
        QS=plan.sendS_idx.shape[-1], QG=plan.gpack_idx.shape[-1],
        QR=plan.rpack_idx.shape[-1], halo_pad=plan.halo_pad, sub=sub)


# --- the exchange's all-to-alls ----------------------------------------------

def _a2a_local(T: DeviceTAP, buf: torch.Tensor) -> torch.Tensor:
    """all_to_all over the local axis of a [S, L, Q] buffer: shard (h, l)
    sends its row j to shard (h, j), which keeps it as its row l."""
    if T.sub is not None:            # [1, L, Q]: over the host's group
        return T.sub[0].all_to_all(buf[0])[None]
    H, L = T.H, T.L
    return buf.reshape(H, L, L, -1).transpose(1, 2).reshape(H * L, L, -1)


def _a2a_host(T: DeviceTAP, buf: torch.Tensor) -> torch.Tensor:
    """all_to_all over the host axis of a [S, H, Q] buffer: shard (h, l)
    sends its row k to shard (k, l), which keeps it as its row h."""
    if T.sub is not None:            # [1, H, Q]: over the local index's
        return T.sub[1].all_to_all(buf[0])[None]
    H, L = T.H, T.L
    return (buf.reshape(H, L, H, -1).permute(2, 1, 0, 3)
            .reshape(H * L, H, -1))


def _flat_take(buf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather from a shard's flattened buffer."""
    return _take(buf.reshape(buf.shape[0], -1), idx)


def tap_halo_exchange(T: DeviceTAP, x: torch.Tensor) -> torch.Tensor:
    """Forward 3-step exchange (TAPComm::communicate,
    core/comm_pkg.hpp:1508-1573): local cols x [S, C] -> halo values
    [S, halo_pad] in off_proc column order."""
    # L: direct intra-host
    recvL = _a2a_local(T, _take(x, T.sendL_idx))         # [S, L, QL]
    # S: owners -> gateways (intra-host)
    recvS = _a2a_local(T, _take(x, T.sendS_idx))         # [S, L, QS]
    # G: gateway -> gateway (across hosts)
    gsend = _flat_take(recvS, T.gpack_idx) * T.gpack_mask
    recvG = _a2a_host(T, gsend)                          # [S, H, QG]
    # R: gateways -> requesters (intra-host)
    rsend = _flat_take(recvG, T.rpack_idx) * T.rpack_mask
    recvR = _a2a_local(T, rsend)                         # [S, L, QR]
    # assemble the halo in off_proc column order
    return (T.haloL_mask * _flat_take(recvL, T.haloL_src)
            + T.haloR_mask * _flat_take(recvR, T.haloR_src))


def tap_halo_exchange_T(T: DeviceTAP, halo_vals: torch.Tensor,
                        n_out: int) -> torch.Tensor:
    """Transpose 3-step exchange with sum reductions
    (TAPComm::communicate_T, core/comm_pkg.hpp:1575-1720): halo
    contributions [S, halo] added back at the owners' local cols
    [S, n_out]."""
    S = halo_vals.shape[0]
    # reverse L
    bufL = _take(halo_vals, T.slotL_to_halo) * T.recvL_mask
    backL = _a2a_local(T, bufL) * T.sendL_mask
    out = _scatter_add(n_out, T.sendL_idx, backL)
    # reverse R: requesters -> gateways, summed into the G layout
    bufR = _take(halo_vals, T.slotR_to_halo) * T.recvR_mask
    backR = _a2a_local(T, bufR) * T.rpack_mask           # at the gateway
    gbuf = _scatter_add(T.H * T.QG, T.revR_target, backR).reshape(
        S, T.H, T.QG)
    # reverse G
    backG = _a2a_host(T, gbuf) * T.gpack_mask            # at src gateway
    sbuf = _scatter_add(T.L * T.QS, T.revG_target, backG).reshape(
        S, T.L, T.QS)
    # reverse S: gateways -> owners
    backS = _a2a_local(T, sbuf) * T.sendS_mask
    return out + _scatter_add(n_out, T.sendS_idx, backS)
