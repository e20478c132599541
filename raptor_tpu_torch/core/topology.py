"""Machine-topology rank reordering, the Topology analog (copy of
raptor_tpu.core.topology).

The reference learns which MPI ranks share a node from the MPICH-style
rank-reorder method (core/topology.hpp:43-57, env
``RAPtor_MPICH_RANK_REORDER_METHOD``): 0 = round-robin over nodes,
1 = blocked (the standard), 2 = folded round-robin. Node-aware (TAP)
communication then routes around that placement.

Here the placement of shards on the (host, local) slots of a 2-D TAP
layout is ours to choose, so the same knob becomes a shard -> slot
permutation: ``shard_slots`` says which slot each contiguous row block
occupies, and ``reorder_shards`` applies it to the operator (a symmetric
row / column permutation: the data motion an MPI rank reordering causes).
The environment variables ``PPN`` and ``RAPTOR_RANK_REORDER_METHOD``
override the constructor's arguments, as in the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

ENV_METHOD = "RAPTOR_RANK_REORDER_METHOD"   # analog of
#                                             RAPtor_MPICH_RANK_REORDER_METHOD
ENV_PPN = "PPN"


class Topology:
    """Rank -> (node, local-proc) map for methods 0/1/2
    (core/topology.hpp:34-120): ``ppn`` processes per node (env ``PPN``
    wins), ``rank_ordering`` 0/1/2 (env ``RAPTOR_RANK_REORDER_METHOD``
    wins)."""

    def __init__(self, n_procs: int, ppn: int = 16,
                 rank_ordering: int = 1):
        self.ppn = int(os.environ.get(ENV_PPN, ppn))
        self.rank_ordering = int(os.environ.get(ENV_METHOD, rank_ordering))
        if self.rank_ordering not in (0, 1, 2):
            raise ValueError(
                f"rank ordering {self.rank_ordering} not supported")
        self.n_procs = n_procs
        self.num_nodes = -(-n_procs // self.ppn)

    def get_node(self, proc: int) -> int:
        o, N = self.rank_ordering, self.num_nodes
        if o == 0:
            return proc % N
        if o == 1:
            return proc // self.ppn
        if (proc // N) % 2 == 0:            # method 2: folded round-robin
            return proc % N
        return N - (proc % N) - 1

    def get_local_proc(self, proc: int) -> int:
        if self.rank_ordering == 1:
            return proc % self.ppn
        return proc // self.num_nodes

    def shard_slots(self) -> np.ndarray:
        """slots[s] = flat (host, local) slot of shard s; a permutation of
        range(n_procs) when n_procs = nodes * ppn."""
        s = np.arange(self.n_procs)
        node = np.fromiter((self.get_node(int(i)) for i in s), np.int64,
                           len(s))
        loc = np.fromiter((self.get_local_proc(int(i)) for i in s),
                          np.int64, len(s))
        return node * self.ppn + loc


def reorder_shards(a, topology: Topology):
    """Move contiguous row block s onto slot ``topology.shard_slots()[s]``:
    the data motion of an MPI rank reordering, as a symmetric permutation
    by ``repartition_matrix``. Returns (A_new, perm) with
    ``perm[new_global] = old_global``. Raises unless the slots are a
    permutation of the shards (``n_procs`` nodes x ``ppn``)."""
    from raptor_tpu_torch.linalg.repartition import repartition_matrix
    slots = topology.shard_slots()
    if not np.array_equal(np.sort(slots), np.arange(len(slots))):
        raise ValueError("shard->slot map is not a permutation "
                         f"(n_procs {topology.n_procs} not nodes*ppn?)")
    bounds = a.partition.row_bounds
    proc_of_row = np.repeat(slots, np.diff(bounds))
    return repartition_matrix(a, proc_of_row)
