"""Communication model (copy of raptor_tpu.profiling.comm_model).

The counterpart of profiling/profile_comm.cpp:1-369: a halo-exchange
schedule's messages by size class (short < 500 B, eager < 8000 B,
rendezvous) and locality (intra-host or inter-host), with the largest
message and byte counts a shard sends and a host pair carries. It reads
the static plans (``comm.plan.CommPlan``, ``comm.tap.TAPPlanHost``), so
the figures are exact and need no instrumented run (the reference
instruments MPI at run time, core/mpi_types.cpp:64-331, and reduces the
maxima per process and node pair by protocol class,
profile_comm.cpp:16-112). Host only."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from raptor_tpu_torch.comm.plan import CommPlan
from raptor_tpu_torch.comm.tap import TAPPlanHost

SHORT_CUTOFF = 500     # bytes (profile_comm.cpp:4)
EAGER_CUTOFF = 8000    # bytes (profile_comm.cpp:5)

CLASSES = ("short", "eager", "rendezvous")


def _classify(nbytes: int) -> str:
    if nbytes < SHORT_CUTOFF:
        return "short"
    if nbytes < EAGER_CUTOFF:
        return "eager"
    return "rendezvous"


@dataclasses.dataclass
class CommStats:
    n_msgs: Dict[str, int]
    n_bytes: Dict[str, int]
    max_msgs_per_shard: int
    max_bytes_per_shard: int
    intra_host_bytes: int
    inter_host_bytes: int
    # per-host-pair maxima over DISTINCT host pairs (profile_comm.cpp's
    # node-pair reduction); 0 when the plan never crosses hosts
    max_msgs_per_host_pair: int = 0
    max_bytes_per_host_pair: int = 0
    # TAP plans: per-step breakdown (L/S/G/R), each a full CommStats
    steps: Optional[Dict[str, "CommStats"]] = None

    def __str__(self):
        lines = ["comm model (bytes/messages by protocol class):"]
        for k in CLASSES:
            lines.append(f"  {k:10s}: {self.n_msgs.get(k, 0):6d} msgs, "
                         f"{self.n_bytes.get(k, 0):10d} B")
        lines.append(f"  max per shard: {self.max_msgs_per_shard} msgs, "
                     f"{self.max_bytes_per_shard} B")
        lines.append(f"  max per host pair: {self.max_msgs_per_host_pair} "
                     f"msgs, {self.max_bytes_per_host_pair} B")
        lines.append(f"  intra-host {self.intra_host_bytes} B / "
                     f"inter-host {self.inter_host_bytes} B")
        if self.steps:
            for name, st in self.steps.items():
                tot_m = sum(st.n_msgs.get(k, 0) for k in CLASSES)
                tot_b = sum(st.n_bytes.get(k, 0) for k in CLASSES)
                lines.append(
                    f"  step {name}: {tot_m} msgs, {tot_b} B "
                    f"(max/shard {st.max_msgs_per_shard} msgs "
                    f"{st.max_bytes_per_shard} B; "
                    + ", ".join(f"{k} {st.n_msgs.get(k, 0)}"
                                for k in CLASSES) + ")")
        return "\n".join(lines)


class _Acc:
    """Accumulate (sender, receiver, nbytes) messages into CommStats."""

    def __init__(self, n_shards: int, shards_per_host: int):
        self.S = n_shards
        self.L = shards_per_host
        # ceil: the last host may be partial
        H = max(1, -(-n_shards // shards_per_host))
        self.n_msgs: Dict[str, int] = {}
        self.n_bytes: Dict[str, int] = {}
        self.per_shard_msgs = np.zeros(n_shards, dtype=np.int64)
        self.per_shard_bytes = np.zeros(n_shards, dtype=np.int64)
        self.pair_msgs = np.zeros((H, H), dtype=np.int64)
        self.pair_bytes = np.zeros((H, H), dtype=np.int64)
        self.intra = 0
        self.inter = 0

    def add(self, sender: int, receiver: int, nbytes: int) -> None:
        if sender == receiver or nbytes <= 0:
            return
        cls = _classify(nbytes)
        self.n_msgs[cls] = self.n_msgs.get(cls, 0) + 1
        self.n_bytes[cls] = self.n_bytes.get(cls, 0) + nbytes
        self.per_shard_msgs[sender] += 1
        self.per_shard_bytes[sender] += nbytes
        ho, hr = sender // self.L, receiver // self.L
        if ho == hr:
            self.intra += nbytes
        else:
            self.inter += nbytes
            self.pair_msgs[ho, hr] += 1
            self.pair_bytes[ho, hr] += nbytes

    def stats(self) -> CommStats:
        return CommStats(
            self.n_msgs, self.n_bytes,
            int(self.per_shard_msgs.max(initial=0)),
            int(self.per_shard_bytes.max(initial=0)),
            self.intra, self.inter,
            int(self.pair_msgs.max(initial=0)),
            int(self.pair_bytes.max(initial=0)))


def model_comm_plan(plan: CommPlan, word_bytes: int = 8,
                    shards_per_host: int = None) -> CommStats:
    """Analyze a plain halo-exchange plan (ParComm equivalent)."""
    S = plan.n_shards
    L = shards_per_host or S
    cnt = plan.send_mask.sum(axis=2).astype(np.int64)  # [S, S] values sent
    acc = _Acc(S, L)
    for o in range(S):
        for r in range(S):
            if cnt[o, r]:
                acc.add(o, r, int(cnt[o, r]) * word_bytes)
    return acc.stats()


def model_tap_plan(plan: TAPPlanHost, word_bytes: int = 8) -> CommStats:
    """Analyze the TAP 4-step schedule exactly from its static masks.

    Messages, per step (tap.py:40-70 layout; reference tap_comm.cpp's
    local_L/local_S/global/local_R par_comms):
      L: owner shard s -> same-host requester l     (intra, direct halo)
      S: owner shard s -> same-host gateway l       (intra, to cross later)
      G: gateway s (host A) -> gateway on host h    (inter, deduplicated)
      R: gateway s -> same-host requester l         (intra, redistribute)
    The G-step receiver is host h's gateway for the (A, h) pair, which
    shares the sender's local index (gateway(A,B) = (A+B) % L is
    host-symmetric, tap.py:86-87)."""
    S, H, L = plan.H * plan.L, plan.H, plan.L
    total = _Acc(S, L)
    steps: Dict[str, CommStats] = {}

    def run_step(name, mask, receiver_of):
        acc = _Acc(S, L)
        cnt = mask.sum(axis=2).astype(np.int64)   # [S, peers]
        for s in range(S):
            for p in range(cnt.shape[1]):
                if cnt[s, p]:
                    r = receiver_of(s, p)
                    b = int(cnt[s, p]) * word_bytes
                    acc.add(s, r, b)
                    total.add(s, r, b)
        steps[name] = acc.stats()

    host_base = lambda s: (s // L) * L                      # noqa: E731
    run_step("L", plan.sendL_mask, lambda s, l: host_base(s) + l)
    run_step("S", plan.sendS_mask, lambda s, l: host_base(s) + l)
    run_step("G", plan.gpack_mask, lambda s, h: h * L + (s % L))
    run_step("R", plan.rpack_mask, lambda s, l: host_base(s) + l)

    out = total.stats()
    out.steps = steps
    return out
