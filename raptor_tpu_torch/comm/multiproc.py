"""Multi-process transport (copy of raptor_tpu.comm.multiproc): the
setup-phase primitives over real OS processes, one shard per rank.

The reference's MPI layer for the setup phase (core/comm_pkg.hpp:302-986
ParComm, core/comm_data.hpp message schedules, core/comm_mat.cpp
matrix-row communication): every rank holds ONLY its row block (a
local-view ``ParCSRMatrix``) and every exchange moves bytes through OS
channels. No process ever holds a global matrix; O(global_n) vectors (CF
states, weights) are the only replicated state, as the reference's
per-rank ``states`` arrays are.

Pieces:

- ``GroupBase``: the collectives (``alltoall``, ``gather0_bcast``,
  ``allgather``) over an abstract tagged send / receive, shared by
  ``ProcessGroup`` and the TCP group (``comm.netgroup.SocketGroup``).
- ``ProcessGroup``: rank / world, one inbox queue per rank and a
  collective sequence number. Sends are tagged ``(seq, kind)`` so that
  out-of-order deliveries park in a stash (the reference uses distinct
  MPI tags per round for the same reason, comm_pkg.hpp:646).
- ``MultiProcessTransport``: the ``Transport`` primitives for one
  distributed matrix. Construction builds the static halo plan by
  exchanging wanted-column lists with the owner ranks: the
  ``init_par_comm`` handshake (comm_pkg.hpp:432-495), with the
  ``MPI_Allreduce(recv_sizes)`` and probe replaced by a deterministic
  all-to-all of (possibly empty) request lists. Its arithmetic is the JAX
  package's (``ufunc.at`` in ``reduce``; the reduce-scatter and allgather
  of ``allreduce_vec``), so the setups over processes are bit-identical
  to the in-process ones.
- ``run_spmd``: a fork-based launcher that runs ``fn(rank, group, *args)``
  in ``world`` processes and returns every rank's result.

The algorithms of ``ruge_stuben.par_setup`` and ``comm.spmd`` run
unchanged on top: pass a local-view matrix and
``MultiProcessTransport(group, a_local)``.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection as mp_connection
import time
from typing import Dict, List, Tuple

import numpy as np

from raptor_tpu_torch.comm.transport import (Transport, _extract_rows,
                                             _owner_of)
from raptor_tpu_torch.core.matrix import CSRMatrix


class GroupBase:
    """Collectives over an abstract tagged point-to-point send / receive,
    shared by the queue group (one machine) and the TCP socket group
    (``comm.netgroup``)."""

    rank: int
    world: int

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def send(self, dst: int, tag, payload) -> None:
        raise NotImplementedError

    def recv(self, tag, src: int):
        raise NotImplementedError

    # --- generic collectives ------------------------------------------------
    def alltoall(self, payloads: List) -> List:
        """payloads[d] goes to rank d; returns what every rank sent me
        (indexed by source rank)."""
        seq = self.next_seq()
        tag = (seq, "a2a")
        for d in range(self.world):
            self.send(d, tag, payloads[d])
        return [self.recv(tag, s) for s in range(self.world)]

    def gather0_bcast(self, value, combine):
        """Gather to rank 0, combine, broadcast the result."""
        seq = self.next_seq()
        if self.rank == 0:
            parts = [value] + [self.recv((seq, "g"), s)
                               for s in range(1, self.world)]
            out = combine(parts)
            for d in range(1, self.world):
                self.send(d, (seq, "b"), out)
            return out
        self.send(0, (seq, "g"), value)
        return self.recv((seq, "b"), 0)

    def allgather(self, value) -> List:
        """Every rank's value, indexed by rank."""
        return self.alltoall([value] * self.world)


class ProcessGroup(GroupBase):
    """Rank-local handle on the process world: tagged point-to-point over
    one inbox queue per rank and a shared collective sequence."""

    def __init__(self, rank: int, world: int, inboxes):
        self.rank = int(rank)
        self.world = int(world)
        self.inboxes = inboxes
        self._seq = 0
        self._stash: Dict[Tuple, object] = {}

    def send(self, dst: int, tag, payload) -> None:
        if dst == self.rank:
            self._stash[(tag, self.rank)] = payload
            return
        self.inboxes[dst].put((tag, self.rank, payload))

    def recv(self, tag, src: int):
        key = (tag, src)
        while key not in self._stash:
            t, s, payload = self.inboxes[self.rank].get()
            self._stash[(t, s)] = payload
        return self._stash.pop(key)


class MultiProcessTransport(Transport):
    """Transport primitives for one distributed matrix over a group: one
    shard per rank (``a`` is this rank's local view, holding exactly
    shard ``group.rank``)."""

    def __init__(self, group: GroupBase, a):
        part = a.partition
        blocks = a.shards()
        if part.n_shards != group.world or len(blocks) != 1 \
                or a.first_shard != group.rank:
            raise ValueError(
                f"multi-process transport: one shard per rank; rank "
                f"{group.rank} of {group.world} holds shards "
                f"[{a.first_shard}, {a.first_shard + len(blocks)}) of "
                f"{part.n_shards}")
        self.group = group
        self.S = 1
        self.first_shard = group.rank
        self.col_bounds = np.asarray(part.col_bounds)
        self.row_bounds = np.asarray(part.row_bounds)
        self.n_cols_total = int(part.global_num_cols)
        blk = blocks[0]
        self.blk = blk
        self.my_map = np.asarray(blk.off_proc_column_map)
        self.c0 = int(self.col_bounds[group.rank])

        # --- static halo plan (init_par_comm, comm_pkg.hpp:432-495) ----
        owners = _owner_of(self.my_map, self.col_bounds)
        self.recv_pos = []    # positions in my_map served by each rank
        req = []
        for o in range(group.world):
            sel = np.nonzero(owners == o)[0]
            self.recv_pos.append(sel)
            req.append(self.my_map[sel])
        # all-to-all of wanted global cols; what rank s wants from me, as
        # LOCAL column indices (the reference's send schedule)
        got = group.alltoall(req)
        self.send_idx = [np.asarray(g, dtype=np.int64) - self.c0
                         for g in got]

    # --- forward: owners -> requesters -----------------------------------
    def fetch(self, local_vals: List[np.ndarray]) -> List[np.ndarray]:
        v = np.asarray(local_vals[0])
        payloads = [v[idx] for idx in self.send_idx]
        got = self.group.alltoall(payloads)
        out = np.zeros(len(self.my_map), dtype=v.dtype)
        for o in range(self.group.world):
            if len(self.recv_pos[o]):
                out[self.recv_pos[o]] = got[o]
        return [out]

    # --- transpose: requesters -> owners ----------------------------------
    def reduce(self, halo_vals: List[np.ndarray], op: str = "add",
               init: float = 0.0) -> List[np.ndarray]:
        h = np.asarray(halo_vals[0])
        payloads = [h[self.recv_pos[o]] for o in range(self.group.world)]
        got = self.group.alltoall(payloads)
        n = self.blk.on_proc_num_cols
        out = np.full(n, init, dtype=np.float64)
        ufunc = {"add": np.add, "max": np.maximum}[op]
        for o in range(self.group.world):
            if len(self.send_idx[o]):
                ufunc.at(out, self.send_idx[o], got[o])
        return [out]

    # --- collectives -------------------------------------------------------
    def allreduce_sum(self, local_scalars: List[float]) -> float:
        return float(np.sum(self.group.allgather(
            float(np.sum(local_scalars)))))

    def allreduce_vec(self, partials: List[np.ndarray],
                      op: str = "add") -> np.ndarray:
        """Reduce-scatter then allgather over chunks via all-to-all: every
        link carries about n / world elements in both phases (MPI's
        large-vector allreduce), where a star through rank 0 would
        serialise O(world * n)."""
        mine = np.sum(partials, axis=0) if op == "add" \
            else np.maximum.reduce(partials)
        world = self.group.world
        if world == 1:
            return mine
        flat = np.ascontiguousarray(mine).reshape(-1)
        chunks = np.array_split(flat, world)
        got = self.group.alltoall(chunks)   # got[src]: src's copy of my chunk
        red = (np.sum(got, axis=0) if op == "add"
               else np.maximum.reduce(got))
        full = np.concatenate(self.group.allgather(red))
        return full.reshape(mine.shape).astype(mine.dtype, copy=False)

    def allgather_obj(self, obj) -> List:
        return self.group.allgather(obj)

    def alltoall_obj(self, payloads: List[List]) -> List[List]:
        assert len(payloads) == 1
        return [self.group.alltoall(list(payloads[0]))]

    def exscan_sum(self, local_scalars: List[float]) -> List[float]:
        all_sums = self.group.allgather(float(np.sum(local_scalars)))
        return [float(np.sum(all_sums[:self.group.rank]))]

    def allgather_concat(self,
                         local_arrays: List[np.ndarray]) -> np.ndarray:
        mine = (np.concatenate(local_arrays) if len(local_arrays) > 1
                else np.asarray(local_arrays[0]))
        return np.concatenate(self.group.allgather(mine))

    def fetch_ids(self, local_vals: List[np.ndarray],
                  wanted_ids: List[np.ndarray]) -> List[np.ndarray]:
        v = np.asarray(local_vals[0])
        ids = np.asarray(wanted_ids[0], dtype=np.int64)
        owners = _owner_of(ids, self.col_bounds)
        req, pos = [], []
        for o in range(self.group.world):
            sel = np.nonzero(owners == o)[0]
            pos.append(sel)
            req.append(ids[sel])
        got_req = self.group.alltoall(req)
        replies = [v[np.asarray(g, dtype=np.int64) - self.c0]
                   for g in got_req]
        got = self.group.alltoall(replies)
        out = np.zeros(len(ids), dtype=v.dtype)
        for o in range(self.group.world):
            if len(pos[o]):
                out[pos[o]] = got[o]
        return [out]

    def fetch_rows(self, src, wanted: List[np.ndarray],
                   row_bounds=None) -> List[tuple]:
        blocks, bounds = self._src_blocks(src, row_bounds)
        my_block = blocks[0]
        r0 = int(bounds[self.group.rank])
        rows = np.asarray(wanted[0], dtype=np.int64)
        owners = _owner_of(rows, bounds)
        req, pos = [], []
        for o in range(self.group.world):
            sel = np.nonzero(owners == o)[0]
            pos.append(sel)
            req.append(rows[sel])
        got_req = self.group.alltoall(req)
        replies = [
            _extract_rows(my_block,
                          np.asarray(g, dtype=np.int64) - r0)
            for g in got_req]
        got = self.group.alltoall(replies)
        counts = np.zeros(len(rows), dtype=np.int64)
        for o in range(self.group.world):
            ip = got[o][0]
            counts[pos[o]] = np.diff(ip)
        indptr = np.concatenate(([0], np.cumsum(counts)))
        cols = np.zeros(int(indptr[-1]), dtype=np.int64)
        vals = np.zeros(int(indptr[-1]))
        for o in range(self.group.world):
            ip, cc, vv = got[o]
            if not len(cc):
                continue
            lens = np.diff(ip)
            dst = (np.repeat(indptr[pos[o]], lens)
                   + (np.arange(len(cc)) - np.repeat(ip[:-1], lens)))
            cols[dst] = cc
            vals[dst] = vv
        return [(indptr.astype(np.int64), cols, vals)]

    def reduce_rows(self, triplets: List[tuple], row_bounds,
                    n_cols: int) -> List[CSRMatrix]:
        import scipy.sparse as sp
        bounds = np.asarray(row_bounds, dtype=np.int64)
        rs = np.concatenate([np.asarray(t[0], dtype=np.int64)
                             for t in triplets])
        cs = np.concatenate([np.asarray(t[1], dtype=np.int64)
                             for t in triplets])
        vs = np.concatenate([np.asarray(t[2]) for t in triplets])
        owners = _owner_of(rs, bounds)
        payloads = []
        for o in range(self.group.world):
            sel = owners == o
            payloads.append((rs[sel], cs[sel], vs[sel]))
        got = self.group.alltoall(payloads)
        r0 = int(bounds[self.group.rank])
        r1 = int(bounds[self.group.rank + 1])
        rr = np.concatenate([g[0] for g in got]) - r0
        cc = np.concatenate([g[1] for g in got])
        vv = np.concatenate([g[2] for g in got])
        g = sp.csr_matrix((vv, (rr, cc)), shape=(r1 - r0, n_cols))
        g.sum_duplicates()
        g.sort_indices()
        return [CSRMatrix.from_scipy(g)]


def _spmd_entry(fn, rank, world, inboxes, conn, args):
    try:
        group = ProcessGroup(rank, world, inboxes)
        out = fn(rank, group, *args)
        conn.send(("ok", out))
    except BaseException as e:  # noqa: BLE001 - reported to the parent
        import traceback
        conn.send(("err", f"rank {rank}: {e}\n{traceback.format_exc()}"))
        raise
    finally:
        conn.close()


def run_spmd(world: int, fn, *args, timeout: float = 300.0) -> List:
    """Run ``fn(rank, group, *args)`` in ``world`` forked processes and
    return every rank's result, in rank order. Raises on any rank's
    failure, with its traceback, or when a rank has not answered within
    ``timeout`` seconds.

    The workers are forked, as the JAX package's are: a fork shares the
    parent's modules, so a worker starts at once and ``fn`` may be a
    test-local function. The forked workers run host NumPy and native
    setup code only, never torch ops: torch's intra-op thread pools do not
    survive a fork, and a torch op in a child can hang on a pool the
    parent started. The device solve across processes runs in
    interpreters started afresh (``comm.launch.run_controllers``)."""
    ctx = mp.get_context("fork")
    inboxes = [ctx.Queue() for _ in range(world)]
    procs, conns = [], []
    for r in range(world):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_spmd_entry,
                        args=(fn, r, world, inboxes, child, args))
        p.start()
        procs.append(p)
        conns.append(parent)
    results = [None] * world
    rank_of = {id(c): r for r, c in enumerate(conns)}
    pending = list(conns)
    deadline = time.monotonic() + timeout
    try:
        # any rank's failure surfaces at once, whichever rank it is
        while pending:
            ready = mp_connection.wait(
                pending, timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                raise TimeoutError(
                    f"ranks {sorted(rank_of[id(c)] for c in pending)} gave "
                    f"no result within {timeout} s")
            for c in ready:
                r = rank_of[id(c)]
                pending.remove(c)
                try:
                    status, payload = c.recv()
                except EOFError:
                    procs[r].join(timeout=10)
                    raise RuntimeError(
                        f"rank {r} exited (code {procs[r].exitcode}) "
                        f"without a result") from None
                if status != "ok":
                    raise RuntimeError(payload)
                results[r] = payload
    finally:
        for p in procs:
            p.join(timeout=0 if pending else 10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return results
