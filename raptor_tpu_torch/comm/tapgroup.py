"""Node-aware (TAP) staging for the setup-phase transport (copy of
raptor_tpu.comm.tapgroup).

The reference routes matrix-row communication through the 2-step
``tap_mat_comm`` (core/comm_pkg.hpp:1392-1451): values bound for a remote
NODE are combined inside the node first, cross the network as ONE message
per node pair, and are redistributed locally, which cuts the inter-node
message count from O(ranks^2) to O(nodes^2).

``TapGroup`` realizes the same schedule underneath any ``GroupBase`` wire
(fork queues on one machine, TCP sockets across hosts): it re-implements
``alltoall``, the primitive every Transport operation (halo fetch,
transpose reduce, matrix-row fetch / reduce) is built on, as intra-node
gather -> one inter-node exchange per node pair -> intra-node scatter.
``MultiProcessTransport(TapGroup(base, ppn), a)`` therefore gives the
whole distributed setup node-aware communication with no change
elsewhere, and the same results bit for bit: it only reorders messages.

The sends are counted (``inter_sends`` across nodes, ``intra_sends``
within a node, a rank's sends to itself in neither), so a caller can
hold the inter-node count against the flat schedule's.
"""

from __future__ import annotations

from typing import List

from raptor_tpu_torch.comm.multiproc import GroupBase


class TapGroup(GroupBase):
    """Two-level collective schedule over a base group.

    ``ppn``: ranks per node (reference Topology PPN,
    core/topology.hpp:32-171); the world must be a multiple of it. Rank r
    lives on node r // ppn, the shard order of ``device.par.Mesh2``. For
    the node pair (A -> B) the aggregator in A is rank A*ppn + (B % ppn)
    and the distributor in B is rank B*ppn + (A % ppn): each rank handles
    about n_nodes / ppn remote nodes, so the staging work is spread across
    the node (form_global_par_comm's balancing, core/tap_comm.cpp:355)."""

    def __init__(self, base: GroupBase, ppn: int):
        if ppn < 1 or base.world % ppn:
            raise ValueError(f"TapGroup: {base.world} ranks are not whole "
                             f"nodes of {ppn}")
        self.base = base
        self.ppn = int(ppn)
        self.rank = base.rank
        self.world = base.world
        self.n_nodes = base.world // self.ppn
        self.node = self.rank // self.ppn
        self.inter_sends = 0
        self.intra_sends = 0

    # point-to-point passes through (gather0_bcast and the like)
    def next_seq(self) -> int:
        return self.base.next_seq()

    def send(self, dst: int, tag, payload) -> None:
        self.base.send(dst, tag, payload)

    def recv(self, tag, src: int):
        return self.base.recv(tag, src)

    def _agg(self, dst_node: int) -> int:
        """My node's aggregator rank for messages to ``dst_node``."""
        return self.node * self.ppn + (dst_node % self.ppn)

    def _dist(self, src_node: int, dst_node: int) -> int:
        """``dst_node``'s distributor rank for messages from ``src_node``."""
        return dst_node * self.ppn + (src_node % self.ppn)

    def _agg_of(self, src_node: int, dst_node: int) -> int:
        """The aggregator in ``src_node`` for traffic to ``dst_node`` (the
        sender of the (seq, "tapG", src_node) message)."""
        return src_node * self.ppn + (dst_node % self.ppn)

    def alltoall(self, payloads: List) -> List:
        """The 3-step node-aware all-to-all (comm_pkg.hpp:1508-1573): L
        (intra-node directs) beside S (bundles to the aggregators) -> G
        (one inter-node message per node pair) -> R (intra-node
        redistribution)."""
        base = self.base
        seq = base.next_seq()
        ppn, node, rank = self.ppn, self.node, self.rank
        mine = range(node * ppn, (node + 1) * ppn)

        # L: destinations on my node go direct
        for d in mine:
            base.send(d, (seq, "tapL"), payloads[d])
            self.intra_sends += int(d != rank)

        # S: each remote node's bundle to my node's aggregator for it
        for N in range(self.n_nodes):
            if N == node:
                continue
            bundle = {d: payloads[d] for d in range(N * ppn, (N + 1) * ppn)}
            a = self._agg(N)
            base.send(a, (seq, "tapS", N), bundle)
            self.intra_sends += int(a != rank)

        # G: an aggregator combines its node's bundles into one message
        # per node pair, to the remote distributor
        for N in range(self.n_nodes):
            if N == node or self._agg(N) != rank:
                continue
            combined = {src: base.recv((seq, "tapS", N), src)
                        for src in mine}
            base.send(self._dist(node, N), (seq, "tapG", node), combined)
            self.inter_sends += 1

        # R: a distributor unpacks and delivers on its node
        for M in range(self.n_nodes):
            if M == node or self._dist(M, node) != rank:
                continue
            combined = base.recv((seq, "tapG", M), self._agg_of(M, node))
            for d in mine:
                base.send(d, (seq, "tapR", M),
                          {src: combined[src][d] for src in combined})
                self.intra_sends += int(d != rank)

        # collect: the directs of my node, then one packet a remote node
        out = [None] * self.world
        for s in mine:
            out[s] = base.recv((seq, "tapL"), s)
        for M in range(self.n_nodes):
            if M == node:
                continue
            packet = base.recv((seq, "tapR", M), self._dist(M, node))
            for src, v in packet.items():
                out[src] = v
        return out
