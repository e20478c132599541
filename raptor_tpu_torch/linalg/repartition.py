"""Repartitioning and row migration (copy of raptor_tpu.linalg.repartition;
util/linalg/repartition.cpp:6,64), with a native graph partitioner standing
in for the reference's ParMETIS / PT-Scotch wrappers
(util/linalg/external/parmetis_wrapper.hpp:12, ptscotch_wrapper.hpp:17).

Both entry points run in two modes, like the reference's (whose
repartition.cpp:64 migrates rows between ranks on distributed data):

- in-process global view (``tr=None``): array permutations of the global
  matrix.
- local view + ``tr`` (a ``comm.transport.Transport``): fully
  distributed, no rank ever assembles the global matrix. Row migration
  rides the transport's matrix-row primitive (``reduce_rows``), column
  relabelling rides ``fetch_ids``, and the partitioner is
  balance-constrained label propagation over the halo seam (the ParMETIS
  stand-in where the multilevel k-way library cannot see the whole
  graph).

Unlike the JAX package, ``partition_graph(method="kway")`` never falls
back to RCM: the native library builds or ``native.load`` raises.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse.csgraph as csgraph

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition


def make_contiguous(a: ParCSRMatrix, proc_of_row, tr=None):
    """Relabel rows/cols so each shard's rows are contiguous in shard order
    (make_contiguous, repartition.cpp:6). Returns (A_new, perm) with
    ``perm[new_global] = old_global``.

    With ``tr`` (local-view mode) ``proc_of_row`` is a per-local-shard
    list of destination arrays and the returned perm is the per-local-
    shard list of old global ids (``perm[i][new_local] = old_global``)."""
    if tr is not None and a.is_local_view:
        return _dist_repartition(a, proc_of_row, tr)
    proc_of_row = np.asarray(proc_of_row)
    S = a.partition.n_shards
    perm = np.argsort(proc_of_row, kind="stable")
    counts = np.bincount(proc_of_row, minlength=S)
    bounds = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    m = a.global_csr.to_scipy()[perm][:, perm].tocsr()
    m.sort_indices()
    part = Partition(a.global_num_rows, a.global_num_cols, S, bounds, bounds)
    return ParCSRMatrix(CSRMatrix.from_scipy(m), part), perm


def repartition_matrix(a: ParCSRMatrix, proc_of_row, tr=None):
    """Apply an arbitrary row->shard assignment (repartition_matrix,
    repartition.cpp:64). Distributed when ``tr`` is given and ``a`` is a
    local view (see the module docstring)."""
    return make_contiguous(a, proc_of_row, tr=tr)


def _dist_repartition(a: ParCSRMatrix, proc_lists: List[np.ndarray], tr):
    """Distributed row migration (repartition.cpp:64): every rank holds
    only its row blocks; rows move to their destination shard through
    the transport's transpose matrix-row primitive, and column ids are
    relabelled through an id-lookup fetch at the owners. No global
    matrix, permutation or assignment vector is ever materialised."""
    part = a.partition
    S = part.n_shards
    n = part.global_num_rows
    if part.global_num_cols != n:
        raise ValueError("repartition needs a square operator")
    shards = a.shards()
    SL = len(shards)
    proc_lists = [np.asarray(p, dtype=np.int64) for p in proc_lists]
    if len(proc_lists) != SL:
        raise ValueError(f"{len(proc_lists)} assignments for {SL} shards")

    # global (source shard, dest part) count matrix -> new bounds and
    # per-source offsets (every rank computes the same small reduction)
    counts_l = [np.bincount(p, minlength=S).astype(np.int64)
                for p in proc_lists]
    cnt = np.vstack([c for part_l in tr.allgather_obj(counts_l)
                     for c in part_l])          # [S, S] source x dest
    totals = cnt.sum(axis=0)
    nb = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(totals, out=nb[1:])
    # offset of source shard g within dest p: rows of lower shards first
    below = np.vstack([np.zeros(S, dtype=np.int64),
                       np.cumsum(cnt, axis=0)[:-1]])

    # new global id of every local row (stable within (source, dest))
    new_ids = []
    for i, proc in enumerate(proc_lists):
        g = tr.first_shard + i
        pos = np.zeros(len(proc), dtype=np.int64)
        for p in np.unique(proc):
            sel = proc == p
            pos[sel] = np.arange(int(sel.sum()))
        new_ids.append(nb[proc] + below[g, proc] + pos)

    # relabel the columns: new id of any referenced old global col id,
    # served by the old owner (fetch_ids: the one-off comm pattern)
    blocks = [blk.global_cols_csr(n) for blk in shards]
    uniq = [np.unique(b.indices) if b.nnz else np.zeros(0, np.int64)
            for b in blocks]
    got = tr.fetch_ids([ni.astype(np.float64) for ni in new_ids], uniq)
    triplets = []
    for i, (blk, b) in enumerate(zip(shards, blocks)):
        lut_pos = np.searchsorted(uniq[i], b.indices)
        new_cols = got[i].astype(np.int64)[lut_pos] if b.nnz \
            else np.zeros(0, np.int64)
        rows_new = np.repeat(new_ids[i], np.diff(b.indptr))
        triplets.append((rows_new, new_cols, b.data))

    # migrate: contributions summed at the new row owners
    new_blocks = tr.reduce_rows(triplets, nb, n)
    new_part = Partition(n, n, S, nb, nb)
    a_new = ParCSRMatrix.from_local_rows(new_blocks, new_part,
                                         first_shard=tr.first_shard)

    # perm[i][new_local] = old_global, exchanged as (new_id, old_gid)
    # pairs addressed by the new owner
    rb = np.asarray(part.row_bounds)
    payloads = []
    for i, ni in enumerate(new_ids):
        old_g = np.arange(rb[tr.first_shard + i],
                          rb[tr.first_shard + i] + len(ni),
                          dtype=np.int64)
        dest = proc_lists[i]
        per_dest = []
        for p in range(S):
            sel = dest == p
            per_dest.append((ni[sel], old_g[sel]))
        payloads.append(per_dest)
    got_pairs = tr.alltoall_obj(payloads)
    perms = []
    for i in range(SL):
        g = tr.first_shard + i
        pl = np.zeros(int(nb[g + 1] - nb[g]), dtype=np.int64)
        for nids, oids in got_pairs[i]:
            pl[np.asarray(nids, np.int64) - nb[g]] = oids
        perms.append(pl)
    return a_new, perms


def partition_graph(a: ParCSRMatrix, n_parts: int = None,
                    method: str = "kway", tr=None):
    """Graph partitioner standing in for ParMETIS_V3_PartKway /
    SCOTCH_dgraphPart (the same call shape: matrix -> row->part
    assignment).

    ``method="kway"`` (default): native multilevel k-way (heavy-edge
    matching coarsening, greedy growing, boundary FM refinement;
    ``native.partition_kway``) on the symmetrised |A| + |A^T| adjacency
    with absolute-value edge weights. There is no fallback: if the native
    library does not build, this raises.
    ``method="rcm"``: reverse Cuthill-McKee banding cut into equal
    contiguous blocks (cheap, bandwidth only).
    ``method="lp"`` with ``tr``, or a local view with ``tr``: balance-
    constrained label propagation over the transport's halo seam
    (``dist_partition_graph``), the fully distributed path; returns a
    per-local-shard list of assignments."""
    n_parts = n_parts or a.partition.n_shards
    if tr is not None and (a.is_local_view or method == "lp"):
        return dist_partition_graph(a, tr, n_parts=n_parts)
    if method not in ("kway", "rcm"):
        raise ValueError(f"partition method {method!r}: 'kway', 'rcm', or "
                         f"'lp' with a transport")
    n = a.global_num_rows
    m = a.global_csr.to_scipy()
    abs_m = abs(m)
    sym = (abs_m + abs_m.T).tocsr()
    if method == "kway":
        from raptor_tpu_torch import native
        sym.setdiag(0)
        sym.eliminate_zeros()
        sym.sort_indices()
        part, _ = native.partition_kway(sym.indptr, sym.indices, sym.data,
                                        n, n_parts)
        return part
    order = csgraph.reverse_cuthill_mckee(sym, symmetric_mode=True)
    proc = np.zeros(n, dtype=np.int64)
    bounds = np.linspace(0, n, n_parts + 1).astype(np.int64)
    for p in range(n_parts):
        proc[order[bounds[p]:bounds[p + 1]]] = p
    return proc


def dist_partition_graph(a: ParCSRMatrix, tr, n_parts: int = None,
                         rounds: int = 8,
                         imbalance: float = 0.05) -> List[np.ndarray]:
    """Distributed graph partitioner: balance-constrained label
    propagation over the halo seam.

    Runs where the reference would call ParMETIS_V3_PartKway on
    distributed CSR (parmetis_wrapper.hpp:12): every rank holds only its
    row blocks, neighbour labels move through ``tr.fetch`` (the static
    halo plan of the SpMV) and the balance bookkeeping through
    allreduces, so the result is the same on every transport for a fixed
    shard layout.

    Each round a row proposes the part with the largest |a_ij| linkage
    among its neighbours (diagonal excluded); proposals are accepted
    best-gain-first under a global capacity of ceil(n/parts) *
    (1 + imbalance) per part, with each rank taking a proportional quota
    of the remaining room. Seeded with the current (contiguous)
    ownership, so it is a refinement: the cut only improves on the block
    partition."""
    part = a.partition
    S = part.n_shards
    n_parts = n_parts or S
    if n_parts != S:
        raise ValueError("dist_partition_graph assigns to the existing "
                         f"shards (n_parts {n_parts} != {S})")
    n = part.global_num_rows
    rb = np.asarray(part.row_bounds)
    shards = a.shards()
    SL = len(shards)
    cap = int(np.ceil(n / n_parts * (1.0 + imbalance)))

    labels = [np.full(int(rb[tr.first_shard + i + 1]
                          - rb[tr.first_shard + i]),
                      tr.first_shard + i, dtype=np.int64)
              for i in range(SL)]
    # static per-shard structure: entry rows and |values|, the diagonal
    # zeroed (self-linkage must not pin a row to its own part), on-proc
    # entries first, then off-proc: the order the scores sum in
    ent = []
    for i, blk in enumerate(shards):
        r0 = blk.first_local_row
        on, off = blk.on_proc, blk.off_proc
        rows_on = np.repeat(np.arange(on.n_rows), np.diff(on.indptr))
        w_on = np.abs(on.data.copy())
        w_on[on.indices + blk.first_local_col == rows_on + r0] = 0.0
        rows_off = np.repeat(np.arange(off.n_rows), np.diff(off.indptr))
        ent.append((np.concatenate([rows_on, rows_off]), on.indices,
                    off.indices, np.concatenate([w_on, np.abs(off.data)])))

    for _ in range(rounds):
        sizes = tr.allreduce_vec(
            [np.bincount(lb, minlength=n_parts).astype(np.float64)
             for lb in labels]).astype(np.int64)
        halo = tr.fetch([lb.astype(np.float64) for lb in labels])
        moves = []      # per shard: (gain, local_row, dest) candidates
        for i, blk in enumerate(shards):
            nr = blk.local_num_rows
            rows, cols_on, cols_off, w = ent[i]
            lab = labels[i][cols_on]
            if len(cols_off):
                lab = np.concatenate([lab,
                                      halo[i].astype(np.int64)[cols_off]])
            # one sequential sum a (row, part) slot, on-proc entries then
            # off-proc ones: np.add.at's order, so the same bits
            score = np.bincount(rows * n_parts + lab, weights=w,
                                minlength=nr * n_parts).reshape(nr, n_parts)
            best = np.argmax(score, axis=1)
            cur = labels[i]
            gain = score[np.arange(nr), best] - score[np.arange(nr), cur]
            sel = np.nonzero((best != cur) & (gain > 0))[0]
            moves.append((gain[sel], sel, best[sel]))
        # global per-dest demand vs room; each rank takes its quota
        want_l = [np.bincount(d, minlength=n_parts).astype(np.float64)
                  for _, _, d in moves]
        want = tr.allreduce_vec(want_l).astype(np.int64)
        room = np.maximum(0, cap - sizes)
        frac = np.where(want > 0, np.minimum(1.0, room / np.maximum(
            want, 1)), 0.0)
        changed = 0.0
        for i, (gain, sel, dest) in enumerate(moves):
            for p in range(n_parts):
                dp = np.nonzero(dest == p)[0]
                take = int(np.floor(frac[p] * len(dp)))
                if take <= 0 or not len(dp):
                    continue
                # best-gain-first, row id as the deterministic tiebreak
                order = dp[np.lexsort((sel[dp], -gain[dp]))][:take]
                labels[i][sel[order]] = p
                changed += take
        if tr.allreduce_sum([changed]) == 0:
            break
    return labels


def comm_volume(a: ParCSRMatrix, proc_of_row: np.ndarray) -> dict:
    """Halo statistics of a row->part assignment on A's pattern: the
    communication the partition would induce (what ParMETIS minimises).

    - ``edge_cut``: nnz whose row and column live on different parts.
    - ``halo_values``: distinct (column, requesting part) pairs, the
      values fetched per SpMV (each column sent once per requesting part,
      the CommPlan dedup).
    - ``max_part_rows``: balance check.
    """
    proc = np.asarray(proc_of_row)
    m = a.global_csr.to_scipy().tocoo()
    rp, cp = proc[m.row], proc[m.col]
    cut = int((rp != cp).sum())
    pairs = np.unique(np.stack([m.col[rp != cp], rp[rp != cp]]), axis=1)
    return {
        "edge_cut": cut,
        "halo_values": int(pairs.shape[1]),
        "max_part_rows": int(np.bincount(proc).max()),
    }
