"""Shard-level setup-phase transport (copy of raptor_tpu.comm.transport:
``Transport`` and ``InProcessTransport``): the distributed-memory seam.

The reference's AMG setup runs distributed over MPI (par_strength.cpp,
par_cf_splitting.cpp, ...): every rank owns its row block and exchanges
halo values / transpose reductions with neighbors. This module is the
same seam for the port's host-side setup: setup algorithms in
``ruge_stuben.par_setup`` operate ONLY on per-shard blocks plus these
primitives:

- ``fetch(locals)``   — forward halo exchange: values of my off_proc
                        columns, fetched from their owners
                        (ParComm::communicate, core/comm_pkg.hpp:631-652)
- ``reduce(halos)``   — transpose exchange: my contributions to remote
                        columns, combined at their owners with add/max
                        (ParComm::communicate_T, core/comm_pkg.hpp:756-800)
- ``allreduce_sum`` / ``allreduce_vec`` / ``exscan_sum`` — collectives
                        (RAPtor_MPI_Allreduce / MPI_Exscan)
- ``fetch_ids``       — values for arbitrary global ids (distance-2
                        fringe data; par_mis.cpp comm_coarse_dist1)
- ``fetch_rows``      — matrix-row communication: CSR rows shipped from
                        their owners (core/comm_mat.cpp:53-150)
- ``reduce_rows``     — transpose matrix communication: partial COO rows
                        summed at the row owners (comm_mat.cpp:209-346)
- ``allgather_concat``— concatenation of per-shard vectors on every rank
                        (MPI_Allgatherv; O(global_n) vectors only, never
                        the matrix)

Every primitive is a collective over *local* shards: the lists passed in
and returned hold one entry per shard OWNED BY THIS PROCESS.
``InProcessTransport`` owns every shard in one process (exact and
deterministic). No implementation ever touches a global matrix: matrix
data flows only as per-shard row blocks.
``comm.multiproc.MultiProcessTransport`` runs the same primitives over
real OS processes, one shard per rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from raptor_tpu_torch.core.matrix import CSRMatrix


def _owner_of(ids: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Owner shard of each global id under contiguous ``bounds``
    (assumed-partition lookup, core/partition.hpp:284-325)."""
    return np.searchsorted(np.asarray(bounds), np.asarray(ids),
                           side="right") - 1


def _extract_rows(csr: CSRMatrix, local_rows: np.ndarray):
    """(indptr, cols, vals) of ``local_rows`` of ``csr``, in order."""
    local_rows = np.asarray(local_rows, dtype=np.int64)
    counts = (np.diff(csr.indptr)[local_rows] if len(local_rows)
              else np.zeros(0, dtype=np.int64))
    indptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    total = int(indptr[-1])
    if total:
        # ragged gather: src start of each row repeated along its length
        idx = (np.repeat(csr.indptr[local_rows], counts)
               + (np.arange(total) - np.repeat(indptr[:-1], counts)))
    else:
        idx = np.zeros(0, dtype=np.int64)
    return indptr, csr.indices[idx].astype(np.int64), csr.data[idx]


def rows_to_csr(indptr, cols, vals, n_rows: int,
                n_cols: int) -> "CSRMatrix":
    import scipy.sparse as sp
    g = sp.csr_matrix((vals, cols, indptr), shape=(n_rows, n_cols))
    g.sum_duplicates()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def split_rows(csr: CSRMatrix, bounds: Sequence[int]) -> List[CSRMatrix]:
    """Split a (test-side, all-local) CSR into per-shard row blocks that
    keep GLOBAL column ids — the canonical matrix wire format."""
    out = []
    for s in range(len(bounds) - 1):
        out.append(csr.row_slice(int(bounds[s]), int(bounds[s + 1])))
    return out


class Transport:
    """Abstract transport: collectives over this process's shards."""

    S: int                    # number of LOCAL shards
    first_shard: int          # global index of the first local shard
    col_bounds: np.ndarray    # GLOBAL column partition (O(n_shards))

    # --- forward: owners -> requesters -----------------------------------
    def fetch(self, local_vals: List[np.ndarray]) -> List[np.ndarray]:
        raise NotImplementedError

    # --- transpose: requesters -> owners ----------------------------------
    def reduce(self, halo_vals: List[np.ndarray], op: str = "add",
               init: float = 0.0) -> List[np.ndarray]:
        raise NotImplementedError

    # --- collectives -------------------------------------------------------
    def allreduce_sum(self, local_scalars: List[float]) -> float:
        raise NotImplementedError

    def allreduce_vec(self, partials: List[np.ndarray],
                      op: str = "add") -> np.ndarray:
        raise NotImplementedError

    def exscan_sum(self, local_scalars: List[float]) -> List[float]:
        raise NotImplementedError

    def allgather_concat(self,
                         local_arrays: List[np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def fetch_ids(self, local_vals: List[np.ndarray],
                  wanted_ids: List[np.ndarray]) -> List[np.ndarray]:
        raise NotImplementedError

    def fetch_rows(self, src, wanted: List[np.ndarray],
                   row_bounds=None) -> List[tuple]:
        raise NotImplementedError

    def reduce_rows(self, triplets: List[tuple], row_bounds,
                    n_cols: int) -> List[CSRMatrix]:
        raise NotImplementedError

    # --- small-object collectives (stat agreement / plan handshakes) -------
    def allgather_obj(self, obj) -> List:
        """Every rank's ``obj``, indexed by rank. Used to agree on
        global format/padding statistics: each rank contributes its
        local stats and every rank runs the same deterministic decision
        on the gathered list (MPI_Allgather of plain data)."""
        raise NotImplementedError

    def alltoall_obj(self, payloads: List[List]) -> List[List]:
        """``payloads[i][d]`` goes from my i-th local shard to shard
        ``d``; returns ``got[i][src]`` = what shard ``src`` sent my i-th
        local shard (the init_par_comm handshake wire,
        core/comm_pkg.hpp:432-495)."""
        raise NotImplementedError

    # --- shared glue -------------------------------------------------------
    def _src_blocks(self, src, row_bounds):
        """Normalize a matrix-row source to (per-LOCAL-shard global-col
        CSR blocks, row_bounds). Accepts a ParCSRMatrix (local or
        in-process view), a list of per-shard row blocks, or an
        all-local global CSR (split by ``row_bounds``)."""
        from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
        if isinstance(src, ParCSRMatrix):
            ncols = src.partition.global_num_cols
            blocks = [blk.global_cols_csr(ncols) for blk in src.shards()]
            return blocks, np.asarray(src.partition.row_bounds)
        if isinstance(src, (list, tuple)):
            assert row_bounds is not None, \
                "per-shard row-block source needs row_bounds"
            return list(src), np.asarray(row_bounds)
        # all-local global CSR (oracle/test path only)
        assert row_bounds is not None, "global-CSR source needs row_bounds"
        return (split_rows(src, row_bounds)[self.first_shard:
                                            self.first_shard + self.S],
                np.asarray(row_bounds))


class InProcessTransport(Transport):
    """All shards live in this process: exchanges are array reshuffles.
    Exact, deterministic, and implementation-shared with the
    multi-process backend through the same per-shard block formats."""

    def __init__(self, a):
        part = a.partition
        self.S = part.n_shards
        self.first_shard = 0
        self.col_bounds = np.asarray(part.col_bounds)
        self.row_bounds = np.asarray(part.row_bounds)
        self.n_cols_total = int(part.global_num_cols)
        # off_proc col maps hold GLOBAL column ids
        self.maps = [np.asarray(blk.off_proc_column_map)
                     for blk in a.shards()]

    # --- forward: owners -> requesters -----------------------------------
    def fetch(self, local_vals: List[np.ndarray]) -> List[np.ndarray]:
        """Per-shard values of the off_proc columns (owned elsewhere)."""
        glob = np.concatenate(local_vals) if self.S > 1 else local_vals[0]
        return [glob[m] for m in self.maps]

    # --- transpose: requesters -> owners ----------------------------------
    def reduce(self, halo_vals: List[np.ndarray], op: str = "add",
               init: float = 0.0) -> List[np.ndarray]:
        """Combine per-shard halo contributions at the owning shard.
        Returns per-shard arrays over LOCAL columns."""
        glob = np.full(self.n_cols_total, init, dtype=np.float64)
        ufunc = {"add": np.add, "max": np.maximum}[op]
        for contrib, m in zip(halo_vals, self.maps):
            if len(m):
                ufunc.at(glob, m, contrib)
        b = self.col_bounds
        return [glob[int(b[s]):int(b[s + 1])] for s in range(self.S)]

    # --- collectives -------------------------------------------------------
    def allreduce_sum(self, local_scalars: List[float]) -> float:
        return float(np.sum(local_scalars))

    def allreduce_vec(self, partials: List[np.ndarray],
                      op: str = "add") -> np.ndarray:
        if op == "add":
            return np.sum(partials, axis=0)
        return np.maximum.reduce(partials)

    def exscan_sum(self, local_scalars: List[float]) -> List[float]:
        """Exclusive prefix sum over shards (MPI_Exscan): shard s gets the
        sum of shards < s. Used for global coarse-index numbering."""
        c = np.concatenate(([0.0], np.cumsum(local_scalars)[:-1]))
        return [float(v) for v in c]

    def allgather_concat(self,
                         local_arrays: List[np.ndarray]) -> np.ndarray:
        return (np.concatenate(local_arrays) if len(local_arrays) > 1
                else np.asarray(local_arrays[0]))

    def allgather_obj(self, obj) -> List:
        return [obj]

    def alltoall_obj(self, payloads: List[List]) -> List[List]:
        # all shards local: a pure transpose
        S = self.S
        return [[payloads[src][i] for src in range(S)] for i in range(S)]

    def fetch_ids(self, local_vals: List[np.ndarray],
                  wanted_ids: List[np.ndarray]) -> List[np.ndarray]:
        """Fetch values for ARBITRARY global ids (distance-2 fringe data;
        the reference builds one-off comm patterns for this, e.g.
        par_mis.cpp comm_coarse_dist1)."""
        glob = np.concatenate(local_vals) if self.S > 1 else local_vals[0]
        return [glob[np.asarray(ids, dtype=np.int64)]
                if len(ids) else np.zeros(0, dtype=glob.dtype)
                for ids in wanted_ids]

    def fetch_rows(self, src, wanted: List[np.ndarray],
                   row_bounds=None) -> List[tuple]:
        """Matrix-row communication (core/comm_mat.cpp:53-150): shard s
        receives the GLOBAL-column CSR rows listed in ``wanted[s]``
        (global row ids, owned by other shards). ``src`` is a
        ParCSRMatrix or a per-shard list of row blocks with global cols.
        Returns per-shard (indptr, global_cols, vals). Rows are always
        extracted from the OWNER's block — no global matrix is read."""
        blocks, bounds = self._src_blocks(src, row_bounds)
        out = []
        for rows in wanted:
            rows = np.asarray(rows, dtype=np.int64)
            owners = _owner_of(rows, bounds)
            parts = {}
            for o in np.unique(owners):
                sel = owners == o
                parts[int(o)] = (sel, _extract_rows(
                    blocks[int(o)], rows[sel] - int(bounds[o])))
            # reassemble in wanted order
            counts = np.zeros(len(rows), dtype=np.int64)
            for o, (sel, (ip, _, _)) in parts.items():
                counts[sel] = np.diff(ip)
            indptr = np.concatenate(([0], np.cumsum(counts)))
            cols = np.zeros(int(indptr[-1]), dtype=np.int64)
            vals = np.zeros(int(indptr[-1]))
            for o, (sel, (ip, cc, vv)) in parts.items():
                if not len(cc):
                    continue
                pos = np.nonzero(sel)[0]
                lens = np.diff(ip)
                # ragged scatter into the wanted-order layout
                dst = (np.repeat(indptr[pos], lens)
                       + (np.arange(len(cc)) - np.repeat(ip[:-1], lens)))
                cols[dst] = cc
                vals[dst] = vv
            out.append((indptr.astype(np.int64), cols, vals))
        return out

    def reduce_rows(self, triplets: List[tuple], row_bounds,
                    n_cols: int) -> List[CSRMatrix]:
        """Transpose matrix communication (comm_mat.cpp:209-346): each
        shard contributes partial rows as (rows, cols, vals) COO with
        GLOBAL ids; contributions are summed at the row owners. Returns
        per-shard LOCAL row blocks (global cols) under ``row_bounds``."""
        import scipy.sparse as sp
        bounds = np.asarray(row_bounds, dtype=np.int64)
        rs = np.concatenate([np.asarray(t[0], dtype=np.int64)
                             for t in triplets])
        cs = np.concatenate([np.asarray(t[1], dtype=np.int64)
                             for t in triplets])
        vs = np.concatenate([np.asarray(t[2]) for t in triplets])
        out = []
        for s in range(len(bounds) - 1):
            r0, r1 = int(bounds[s]), int(bounds[s + 1])
            sel = (rs >= r0) & (rs < r1)
            g = sp.csr_matrix((vs[sel], (rs[sel] - r0, cs[sel])),
                              shape=(r1 - r0, n_cols))
            g.sum_duplicates()
            g.sort_indices()
            out.append(CSRMatrix.from_scipy(g))
        return out
