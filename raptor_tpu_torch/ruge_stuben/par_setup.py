"""Distributed-memory AMG setup stages over per-shard data (copy of
raptor_tpu.ruge_stuben.par_setup).

These are the shard-local + transport formulations of the setup
algorithms (the reference's par_strength.cpp:14-346,
par_cf_splitting.cpp:60-163 / 1273-1641, par_interpolation.cpp and
par_matmult.cpp): each function touches only a shard's on_proc /
off_proc blocks and the transport primitives (``comm.transport``), so the
same code runs when the global matrix never exists on one host. The
host-global implementations (strength.py, cf_splitting.py,
interpolation.py) stay the oracle: the stages give them back for every
shard count, except Falgout and HMIS, whose interior passes depend on the
partition as the reference's do. The smoothed-aggregation stages
(aggregation/par_mis.cpp, par_aggregate.cpp, par_candidates.cpp,
par_prolongation.cpp and the symmetric strength of par_strength.cpp) follow
the same contract; their per-round MIS(2) and aggregation steps run in the
native kernels, as the JAX package's do.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

import scipy.sparse as sp

from raptor_tpu_torch import native
from raptor_tpu_torch.comm.transport import InProcessTransport, Transport
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix, ShardBlocks
from raptor_tpu_torch.core.types import CFState, ZERO_TOL
from raptor_tpu_torch.ruge_stuben.cf_splitting import (
    _pattern, set_initial_states, split_rs)

U, S_, F = CFState.Unassigned, CFState.Selected, CFState.Unselected
NEW_C = CFState.NewSelection
NO_NBR = CFState.NoNeighbors
TMP, NEW_U = CFState.TmpSelection, CFState.NewUnselection


def _per_shard_rows(arr, shards):
    """Per-LOCAL-shard row slices of a global O(n) vector, or pass a
    per-shard list through unchanged. Every function here indexes shard
    data by the shard's own ``first_local_row`` — never by position in a
    global shard list — so the same code runs when this process owns
    only its shards (MultiProcessTransport)."""
    if arr is None:
        return None
    if isinstance(arr, (list, tuple)):
        return [np.asarray(x) for x in arr]
    arr = np.asarray(arr)
    return [arr[blk.first_local_row:
                blk.first_local_row + blk.local_num_rows]
            for blk in shards]


def _matrix_rows(m, shards):
    """Per-LOCAL-shard row blocks (global cols) of a matrix given either
    an all-local global CSR (oracle path) or an already-per-shard list."""
    if isinstance(m, (list, tuple)):
        return list(m)
    return [m.row_slice(blk.first_local_row,
                        blk.first_local_row + blk.local_num_rows)
            for blk in shards]


def dist_classical_strength(a: ParCSRMatrix, theta: float = 0.25,
                            num_variables: int = 1,
                            variables: Optional[np.ndarray] = None,
                            tr: Optional[Transport] = None):
    """Distributed classical strength (par_strength.cpp:14-346).

    Row-local given the shard's on+off blocks; only unknown-based
    filtering needs one halo fetch (of ``variables``). Returns per-shard
    (s_on_mask, s_off_mask): boolean keep-masks over the blocks' entries
    (the strength pattern, diagonal always kept)."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()

    if num_variables != 1:
        local_vars = [
            variables[blk.first_local_col:
                      blk.first_local_col + blk.on_proc_num_cols]
            for blk in shards]
        halo_vars = tr.fetch(local_vars)
    masks = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        r0 = blk.first_local_row
        rows_on = on.row_ids()
        rows_off = off.row_ids()
        n = on.n_rows
        diag = on.diagonal()[:n] if on.n_rows <= on.n_cols else None
        # local diag (row r -> entry at local col r + (r0 - c0) offset);
        # for the square row partition local row r owns local col r
        dloc = np.zeros(n)
        is_diag = on.indices == rows_on + 0  # on_proc local col == row
        dloc[rows_on[is_diag]] = on.data[is_diag]
        neg = dloc < 0.0

        if num_variables != 1:
            rv = variables[r0:r0 + n]
            same_on = rv[rows_on] == local_vars[s][on.indices]
            same_off = rv[rows_off] == halo_vars[s][off.indices]
        else:
            same_on = np.ones(on.nnz, dtype=bool)
            same_off = np.ones(off.nnz, dtype=bool)

        # row scale over same-variable off-diagonals of the FULL row
        mn = np.full(n, np.inf)
        mx = np.full(n, -np.inf)
        sel_on = ~is_diag & same_on
        np.minimum.at(mn, rows_on[sel_on], on.data[sel_on])
        np.maximum.at(mx, rows_on[sel_on], on.data[sel_on])
        if off.nnz:
            sel_off = same_off
            np.minimum.at(mn, rows_off[sel_off], off.data[sel_off])
            np.maximum.at(mx, rows_off[sel_off], off.data[sel_off])
        thr = np.where(neg, mx, mn) * theta

        strong_on = np.where(neg[rows_on], on.data > thr[rows_on],
                             on.data < thr[rows_on])
        strong_off = np.where(neg[rows_off], off.data > thr[rows_off],
                              off.data < thr[rows_off])
        masks.append((is_diag | (sel_on & strong_on),
                      same_off & strong_off))
    return masks


def strength_masks_to_par(a: ParCSRMatrix, masks) -> ParCSRMatrix:
    """S from per-shard keep masks: each shard filters its own blocks
    (S shares A's partition, par_strength.cpp:541-556). No global
    assembly — the result is built shard by shard; when ``a`` is an
    in-process view the global CSR is attached for the oracle tests."""
    blocks = []
    for s, blk in enumerate(a.shards()):
        mon, moff = masks[s]
        on = blk.on_proc.filter_entries(np.asarray(mon, dtype=bool))
        offm = np.asarray(moff, dtype=bool)
        off_f = blk.off_proc.filter_entries(offm) if blk.off_proc.nnz \
            else blk.off_proc
        # re-condense the off map to the surviving columns
        cmap = np.asarray(blk.off_proc_column_map)
        used = np.unique(off_f.indices) if off_f.nnz else \
            np.zeros(0, dtype=np.int64)
        new_map = cmap[used]
        new_idx = np.searchsorted(used, off_f.indices)
        off = CSRMatrix(off_f.n_rows, len(new_map), off_f.indptr,
                        new_idx.astype(np.int64), off_f.data)
        blocks.append(ShardBlocks(
            on_proc=on, off_proc=off,
            off_proc_column_map=new_map.astype(np.int64),
            first_local_row=blk.first_local_row,
            first_local_col=blk.first_local_col))
    out = ParCSRMatrix.from_shard_blocks(blocks, a.partition,
                                         a.first_shard)
    if not a.is_local_view:
        out = ParCSRMatrix(out.assemble_global(), a.partition)
        out._shards = blocks
    return out


def dist_split_pmis(s_par: ParCSRMatrix, rand_vals: np.ndarray,
                    states0=None, max_rounds: int = 10000,
                    tr: Optional[Transport] = None) -> np.ndarray:
    """Distributed PMIS splitting (par_cf_splitting.cpp:128-141 +
    pmis_main_loop:1273-1426): per round, each shard selects rows whose
    weight dominates every strong neighbor in both directions, using one
    weight fetch + one column-max reduction; new C points silence their
    column neighbors. Identical states to the host-global PMIS for any
    shard count (ties have probability zero under random weights).

    Returns the GLOBAL states array (concatenated owner order; under a
    multi-process transport every rank gets the full array via
    allgather)."""
    tr = tr or InProcessTransport(s_par)
    shards = s_par.shards()
    S = len(shards)
    states0_l = _per_shard_rows(states0, shards)

    # diag-stripped per-shard blocks + local transpose patterns
    blocks = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        rows_on = on.row_ids()
        keep = on.indices != rows_on
        on_rows = rows_on[keep]
        on_cols = on.indices[keep]
        n = on.n_rows
        onp = sp.csr_matrix((np.ones(len(on_rows)), (on_rows, on_cols)),
                            shape=(n, on.n_cols))
        onT = onp.tocsc()
        blocks.append((on_rows, on_cols, off.row_ids(), off.indices,
                       onp.tocsr(), onT))

    # initial weights: rand + global strong in-degree (column counts)
    local_w = []
    off_counts = []
    for s, (on_rows, on_cols, off_rows, off_cols, onp, onT) in \
            enumerate(blocks):
        r0 = shards[s].first_local_row
        n = shards[s].on_proc.n_rows
        w = rand_vals[r0:r0 + n].astype(np.float64).copy()
        w += np.bincount(on_cols, minlength=n)[:n]
        local_w.append(w)
        off_counts.append(np.bincount(
            off_cols, minlength=len(shards[s].off_proc_column_map)
        ).astype(np.float64))
    for s, add in enumerate(tr.reduce(off_counts, op="add")):
        local_w[s] += add

    # initial states (or resume from given ones: Falgout/HMIS hybrids)
    local_states = []
    for s, (on_rows, on_cols, off_rows, off_cols, onp, onT) in \
            enumerate(blocks):
        n = shards[s].on_proc.n_rows
        if states0 is not None:
            st = np.asarray(states0_l[s], dtype=np.int64).copy()
        else:
            st = np.full(n, int(U), dtype=np.int64)
            row_deg = (np.bincount(on_rows, minlength=n)
                       + np.bincount(off_rows, minlength=n))
            st[row_deg == 0] = int(NO_NBR)
        if states0 is not None:
            # pre-assigned C points silence their local column
            # neighbors, and assigned nodes stop blocking selection
            # (par_cf_splitting.cpp:1319-1350)
            pre_c = np.nonzero(st == int(S_))[0]
            if len(pre_c):
                hitc = np.isin(on_cols, pre_c)
                rows_hit = on_rows[hitc]
                flip = rows_hit[st[rows_hit] == int(U)]
                st[flip] = int(F)
            local_w[s][st != int(U)] = 0.0
        pre_f = (st == int(U)) & (local_w[s] < 1.0)
        st[pre_f] = int(F)
        local_w[s][pre_f] = 0.0
        local_states.append(st)

    for _ in range(max_rounds):
        remaining = tr.allreduce_sum(
            [int(np.count_nonzero(st == int(U))) for st in local_states])
        if remaining == 0:
            break

        halo_w = tr.fetch(local_w)
        # column-direction maxima contributed by REMOTE rows: for each of
        # my off cols, the max weight of my rows pointing at it
        contrib = []
        for s, (on_rows, on_cols, off_rows, off_cols, onp, onT) in \
                enumerate(blocks):
            h = len(shards[s].off_proc_column_map)
            cm = np.zeros(h)
            if len(off_rows):
                np.maximum.at(cm, off_cols, local_w[s][off_rows])
            contrib.append(cm)
        col_max_remote = tr.reduce(contrib, op="max", init=-np.inf)

        # select: weight strictly dominates all strong neighbors
        new_c = []
        for s, (on_rows, on_cols, off_rows, off_cols, onp, onT) in \
                enumerate(blocks):
            st, w = local_states[s], local_w[s]
            n = len(st)
            # row-direction max (on local + halo cols)
            row_max = np.full(n, -np.inf)
            if len(on_rows):
                np.maximum.at(row_max, on_rows, w[on_cols])
            if len(off_rows):
                np.maximum.at(row_max, off_rows, halo_w[s][off_cols])
            # column-direction max (local rows pointing at me + remote)
            col_max = np.full(n, -np.inf)
            if len(on_rows):
                np.maximum.at(col_max, on_cols, w[on_rows])
            cmr = col_max_remote[s]
            col_max = np.maximum(col_max, cmr[:n])
            sel = (st == int(U)) & (w > row_max) & (w > col_max)
            new_c.append(sel)

        # apply: new C; then rows pointing at a C (either locality) -> F
        halo_new = tr.fetch([nc.astype(np.float64) for nc in new_c])
        for s, (on_rows, on_cols, off_rows, off_cols, onp, onT) in \
                enumerate(blocks):
            st, w = local_states[s], local_w[s]
            sel = new_c[s]
            st[sel] = int(S_)
            w[sel] = 0.0
            # local rows pointing at a local new C
            hit = np.zeros(len(st), dtype=bool)
            if len(on_rows):
                hit_on = sel[on_cols]
                np.logical_or.at(hit, on_rows[hit_on], True)
            # local rows pointing at a remote new C
            if len(off_rows):
                hit_off = halo_new[s][off_cols] > 0.5
                np.logical_or.at(hit, off_rows[hit_off], True)
            to_f = hit & (st == int(U))
            st[to_f] = int(F)
            w[to_f] = 0.0

    return tr.allgather_concat(local_states)


def dist_direct_interpolation(a: ParCSRMatrix, s_masks, states_global,
                              tr: Optional[Transport] = None,
                              assemble: bool = True):
    """Distributed direct interpolation
    (par_interpolation.cpp:1474-1776): entirely row-local given the
    shard's on/off blocks, the strength masks, one halo fetch of CF
    states, and an exclusive scan for global coarse numbering.

    ``assemble=True`` returns the global P CSR (in-process validation);
    ``assemble=False`` returns (per-LOCAL-shard P row blocks with global
    coarse cols, n_coarse) — the SPMD product."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()
    S = len(shards)

    # coarse numbering: local C counts -> exscan -> global coarse ids
    local_states = _per_shard_rows(states_global, shards)
    c_counts = [int(np.count_nonzero(st == int(S_)))
                for st in local_states]
    c_starts = tr.exscan_sum(c_counts)
    n_coarse = int(tr.allreduce_sum(c_counts))
    local_coarse_id = []
    for st, c0 in zip(local_states, c_starts):
        cid = np.cumsum(st == int(S_)) - 1 + int(c0)
        local_coarse_id.append(np.where(st == int(S_), cid, -1))
    halo_states = tr.fetch([st.astype(np.float64)
                            for st in local_states])
    halo_cid = tr.fetch([ci.astype(np.float64)
                         for ci in local_coarse_id])

    rows_g, cols_g, vals_g = [], [], []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        st = local_states[s]
        r0 = 0 if not assemble else blk.first_local_row
        n = on.n_rows
        mon, moff = s_masks[s]
        rows_on, rows_off = on.row_ids(), off.row_ids()
        is_diag = on.indices == rows_on
        dloc = np.zeros(n)
        dloc[rows_on[is_diag]] = on.data[is_diag]

        st_on_col = st[on.indices]          # square-aligned partition
        st_off_col = halo_states[s][off.indices].astype(np.int64) \
            if off.nnz else np.zeros(0, dtype=np.int64)

        def rowsum(rows, vals, mask, n=n):
            return np.bincount(rows[mask], weights=vals[mask], minlength=n)

        neg_on = on.data < 0
        neg_off = off.data < 0
        offd_on = ~is_diag
        sum_all_neg = (rowsum(rows_on, on.data, offd_on & neg_on)
                       + rowsum(rows_off, off.data, neg_off))
        sum_all_pos = (rowsum(rows_on, on.data, offd_on & ~neg_on)
                       + rowsum(rows_off, off.data, ~neg_off))
        sc_on = mon & offd_on & (st_on_col == int(S_))
        sc_off = moff & (st_off_col == int(S_))
        sum_s_neg = (rowsum(rows_on, on.data, sc_on & neg_on)
                     + rowsum(rows_off, off.data, sc_off & neg_off))
        sum_s_pos = (rowsum(rows_on, on.data, sc_on & ~neg_on)
                     + rowsum(rows_off, off.data, sc_off & ~neg_off))

        with np.errstate(divide="ignore", invalid="ignore"):
            alpha = sum_all_neg / sum_s_neg
        no_pos = sum_s_pos == 0
        eff_diag = np.where(no_pos, dloc + sum_all_pos, dloc)
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.where(no_pos, 0.0, sum_all_pos / sum_s_pos)
        neg_co = -alpha / eff_diag
        pos_co = -beta / eff_diag

        for rows, data, cidx, selm in (
                (rows_on, on.data, local_coarse_id[s][on.indices], sc_on),
                (rows_off, off.data,
                 halo_cid[s][off.indices].astype(np.int64)
                 if off.nnz else np.zeros(0, dtype=np.int64), sc_off)):
            f_sel = selm & (st[rows] == int(F))
            rr = rows[f_sel]
            vv = data[f_sel]
            pv = np.where(vv < 0, neg_co[rr] * vv, pos_co[rr] * vv)
            rows_g.append(rr + r0)
            cols_g.append(cidx[f_sel])
            vals_g.append(pv)
        c_rows = np.nonzero(st == int(S_))[0]
        rows_g.append(c_rows + r0)
        cols_g.append(local_coarse_id[s][c_rows])
        vals_g.append(np.ones(len(c_rows)))
        if not assemble:
            blk_rows = [rows_g.pop() for _ in range(3)][::-1]
            blk_cols = [cols_g.pop() for _ in range(3)][::-1]
            blk_vals = [vals_g.pop() for _ in range(3)][::-1]
            rows_g.append(("shard", blk_rows, blk_cols, blk_vals, n))

    if not assemble:
        out = []
        for tag, rr, cc, vv, n in rows_g:
            g = sp.csr_matrix(
                (np.concatenate(vv),
                 (np.concatenate(rr), np.concatenate(cc))),
                shape=(n, n_coarse))
            g.sum_duplicates()
            g.sort_indices()
            out.append(CSRMatrix.from_scipy(g))
        return out, n_coarse
    g = sp.csr_matrix(
        (np.concatenate(vals_g),
         (np.concatenate(rows_g), np.concatenate(cols_g))),
        shape=(a.global_num_rows, n_coarse))
    g.sum_duplicates()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def dist_rap(a: ParCSRMatrix, p,
             tr: Optional[Transport] = None,
             coarse_bounds=None, assemble: bool = True):
    """Distributed Galerkin product C = P^T (A P)
    (util/linalg/par_matmult.cpp:79-363 + mult_T:163-441).

    Per shard: fetch the halo rows of P referenced by A's off block
    (init_par_mat_comm, comm_mat.cpp:53-96), compute the local AP rows,
    form the partial P^T AP contribution, and reduce partial coarse rows
    at their owners (init_mat_comm_T, comm_mat.cpp:209-346). The drop
    rule matches the host SpGEMM (|c| <= zero_tol).

    ``p``: global P CSR (in-process) or per-LOCAL-shard row blocks.
    ``coarse_bounds``: coarse row partition for routing the reduced rows
    (defaults to an even split — fine for assemble=True, required to be
    the real coarse partition for SPMD). ``assemble=False`` returns
    per-LOCAL-shard coarse row blocks."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()
    p_blocks = _matrix_rows(p, shards)
    n_coarse = p_blocks[0].n_cols
    if coarse_bounds is None:
        S_tot = a.partition.n_shards
        coarse_bounds = np.linspace(0, n_coarse, S_tot + 1
                                    ).astype(np.int64)

    wanted = [np.asarray(blk.off_proc_column_map) for blk in shards]
    halo_rows = tr.fetch_rows(p_blocks, wanted,
                              row_bounds=a.partition.row_bounds)

    triplets = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        # local rows of P (global coarse cols); local products run the
        # NATIVE Gustavson / transpose-SpGEMM kernels — the same code
        # the host-global path uses (csrc spgemm/spgemm_t), not scipy
        p_loc = p_blocks[s]
        hi, hc, hv = halo_rows[s]
        ap = on.multiply(p_loc)
        if off.nnz:
            p_halo = CSRMatrix(len(wanted[s]), n_coarse,
                               np.asarray(hi, dtype=np.int64),
                               np.asarray(hc, dtype=np.int64),
                               np.asarray(hv))
            ap = ap.add(off.multiply(p_halo))
        cpart = p_loc.T_multiply(ap)
        triplets.append((cpart.row_ids(), cpart.indices, cpart.data))

    c_blocks = tr.reduce_rows(triplets, coarse_bounds, n_coarse)
    c_blocks = [c.drop(ZERO_TOL) for c in c_blocks]
    if not assemble:
        return c_blocks
    g = sp.vstack([c.to_scipy() for c in c_blocks]).tocsr()
    g.sort_indices()
    return CSRMatrix.from_scipy(g).drop(ZERO_TOL)


def dist_transpose(a: ParCSRMatrix,
                   tr: Optional[Transport] = None,
                   assemble: bool = True):
    """Distributed transpose (core/par_matrix.cpp:694-858): each shard
    emits its entries as (col, row, val) triplets and the transpose rows
    are assembled at their owners via the transpose matrix communication
    (reduce_rows) — no global matrix on any rank.

    ``assemble=False`` returns per-LOCAL-shard row blocks of A^T."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()
    part = a.partition
    G = part.global_num_cols
    triplets = []
    for blk in shards:
        g = blk.global_cols_csr(G)
        rows = g.row_ids() + blk.first_local_row
        triplets.append((g.indices.copy(), rows.astype(np.int64),
                         g.data))
    t_blocks = tr.reduce_rows(triplets, part.col_bounds,
                              part.global_num_rows)
    if not assemble:
        return t_blocks
    g = sp.vstack([b.to_scipy() for b in t_blocks]).tocsr()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def dist_split_cljp(s_par: ParCSRMatrix, rand_vals: np.ndarray,
                    states0=None, max_rounds: int = 10000,
                    tr: Optional[Transport] = None) -> np.ndarray:
    """Distributed CLJP splitting (par_cf_splitting.cpp:85-101 +
    cljp_main_loop:1427-1641 with the distance-2 weight updates
    :590-708 and new-coarse exchange :980).

    Same independent-set selection as PMIS, plus per-round weight
    decrements: (1) edges from a new C along its row, (2) edges between
    two nodes that both point at the same new C. Cross-shard cases use
    one prefetch of the halo S row patterns (find_off_proc_new_coarse's
    job) and per-round fetches of weights/states/new-C flags plus one
    add-reduction of remote decrements. Bit-identical to the host-global
    CLJP for any shard count (decrements are exact integers)."""
    tr = tr or InProcessTransport(s_par)
    shards = s_par.shards()
    states0_l = _per_shard_rows(states0, shards)

    blocks = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        rows_on = on.row_ids()
        keep = on.indices != rows_on
        n = on.n_rows
        # local row patterns (diag-stripped): cols = local ids; off cols
        # indexed h + local-halo-id to keep one sorted id space per row
        h = len(blk.off_proc_column_map)
        row_on = sp.csr_matrix(
            (np.ones(int(keep.sum())), (rows_on[keep], on.indices[keep])),
            shape=(n, on.n_cols)).tocsr()
        row_on.sort_indices()
        row_off = sp.csr_matrix(
            (np.ones(off.nnz), (off.row_ids(), off.indices)),
            shape=(n, max(1, h))).tocsr()
        row_off.sort_indices()
        blocks.append((row_on, row_off, h))

    # prefetch halo S row PATTERNS (global cols) for distance-2 checks
    wanted = [np.asarray(blk.off_proc_column_map) for blk in shards]
    halo_pat = tr.fetch_rows(s_par, wanted)

    # initial weights: rand + strong in-degree
    local_w, off_counts = [], []
    for s, (row_on, row_off, h) in enumerate(blocks):
        r0 = shards[s].first_local_row
        n = row_on.shape[0]
        w = rand_vals[r0:r0 + n].astype(np.float64).copy()
        w += np.bincount(row_on.indices, minlength=n)[:n]
        local_w.append(w)
        off_counts.append(np.bincount(
            row_off.indices, minlength=h).astype(np.float64))
    for s, add in enumerate(tr.reduce(off_counts, op="add")):
        local_w[s] += add

    local_states = []
    for s, (row_on, row_off, h) in enumerate(blocks):
        n = row_on.shape[0]
        if states0 is not None:
            st = np.asarray(states0_l[s], dtype=np.int64).copy()
            local_w[s][st != int(U)] = 0.0
        else:
            st = np.full(n, int(U), dtype=np.int64)
            deg = (np.diff(row_on.indptr) + np.diff(row_off.indptr))
            st[deg == 0] = int(NO_NBR)
        local_states.append(st)

    edgemark_on = [np.ones(b[0].nnz, dtype=np.int64) for b in blocks]
    edgemark_off = [np.ones(b[1].nnz, dtype=np.int64) for b in blocks]
    # int64 copies of the block patterns for the native kernel
    blk64 = [(np.asarray(b[0].indptr, dtype=np.int64),
              np.asarray(b[0].indices, dtype=np.int64),
              np.asarray(b[1].indptr, dtype=np.int64),
              np.asarray(b[1].indices, dtype=np.int64)) for b in blocks]

    for _ in range(max_rounds):
        if tr.allreduce_sum([int(np.count_nonzero(st == int(U)))
                             for st in local_states]) == 0:
            break
        halo_w = tr.fetch(local_w)
        halo_st = tr.fetch([st.astype(np.float64) for st in local_states])

        # select (dominance in both directions), as in dist_split_pmis
        contrib = []
        for s, (row_on, row_off, h) in enumerate(blocks):
            cm = np.zeros(h)
            if row_off.nnz:
                er = np.repeat(np.arange(row_off.shape[0]),
                               np.diff(row_off.indptr))
                np.maximum.at(cm, row_off.indices, local_w[s][er])
            contrib.append(cm)
        col_max_remote = tr.reduce(contrib, op="max", init=-np.inf)

        new_c = []
        for s, (row_on, row_off, h) in enumerate(blocks):
            st, w = local_states[s], local_w[s]
            n = len(st)
            er_on = np.repeat(np.arange(n), np.diff(row_on.indptr))
            er_off = np.repeat(np.arange(n), np.diff(row_off.indptr))
            row_max = np.full(n, -np.inf)
            if len(er_on):
                np.maximum.at(row_max, er_on, w[row_on.indices])
            if len(er_off):
                np.maximum.at(row_max, er_off, halo_w[s][row_off.indices])
            col_max = np.full(n, -np.inf)
            if len(er_on):
                np.maximum.at(col_max, row_on.indices, w[er_on])
            col_max = np.maximum(col_max, col_max_remote[s][:n])
            new_c.append((st == int(U)) & (w > row_max) & (w > col_max))

        halo_new = tr.fetch([nc.astype(np.float64) for nc in new_c])

        # weight updates; remote decrements accumulated per off col
        off_dec = [np.zeros(b[2]) for b in blocks]
        for s, (row_on, row_off, h) in enumerate(blocks):
            st, w = local_states[s], local_w[s]
            n = len(st)
            sel = new_c[s]
            hstU = halo_st[s] == float(int(U))
            hnew = halo_new[s] > 0.5

            hi, hc, _ = halo_pat[s]
            on_ip, on_idx, off_ip, off_idx = blk64[s]
            native.dist_cljp_update(
                n, h, shards[s].first_local_col, on_ip, on_idx,
                off_ip, off_idx, hi, hc, wanted[s],
                np.ascontiguousarray(st), hstU.astype(np.int64),
                sel.astype(np.int64), hnew.astype(np.int64),
                edgemark_on[s], edgemark_off[s], w, off_dec[s])

        for s, dec in enumerate(tr.reduce(off_dec, op="add")):
            local_w[s] += dec

        # update states
        for s in range(len(blocks)):
            st, w = local_states[s], local_w[s]
            sel = new_c[s]
            st[sel] = int(S_)
            w[sel] = 0.0
            drop = (st == int(U)) & (w < 1.0)
            st[drop] = int(F)
            w[drop] = 0.0

    return tr.allgather_concat(local_states)


def _dist_extended_system(a: ParCSRMatrix, s_par: ParCSRMatrix,
                          states_global, tr: Transport,
                          with_fringe: bool):
    """Per-shard "extended" systems for the halo-needing interpolations
    (the reference's communicate(A,S,states) helper,
    par_interpolation.cpp:30-142): rows = [local | halo rows
    (| empty fringe rows) | empty dummy], columns remapped to
    {0..n-1 local} + {n..n+h-1 halo} (+ {n+h.. fringe}) + {dummy}.
    Local rows keep on-then-off entry order (on ids < n <= off ids, so
    already sorted); halo rows are stably re-sorted after remapping —
    identical layout to the original per-row construction, so kernel
    accumulation order (and hence bitwise output) is unchanged.
    Fully vectorized; fringe (distance-2) states/coarse ids are fetched
    with one fetch_ids round when ``with_fringe`` (extended+i needs
    them, mod-classical does not read through distance-2 columns).

    Returns (per-shard dicts, n_coarse)."""
    shards = a.shards()
    s_shards = s_par.shards()
    G = a.partition.global_num_cols

    local_states = _per_shard_rows(states_global, shards)
    c_counts = [int(np.count_nonzero(st == int(S_)))
                for st in local_states]
    c_starts = tr.exscan_sum(c_counts)
    n_coarse = int(tr.allreduce_sum(c_counts))
    local_cid = []
    for st, cst in zip(local_states, c_starts):
        cid = np.cumsum(st == int(S_)) - 1 + int(cst)
        local_cid.append(np.where(st == int(S_), cid, -1).astype(np.int64))
    halo_states = tr.fetch([st.astype(np.float64) for st in local_states])
    halo_cid = tr.fetch([ci.astype(np.float64) for ci in local_cid])

    wanted = [np.asarray(blk.off_proc_column_map) for blk in shards]
    halo_a = tr.fetch_rows(a, wanted)
    halo_s = tr.fetch_rows(s_par, wanted)

    # fringe = distance-2 global cols (in halo rows, neither local nor
    # halo); their states/coarse ids arrive via one dynamic fetch
    # (par_mis.cpp comm_coarse_dist1 analog)
    fringes = []
    for sdx, blk in enumerate(shards):
        if not with_fringe:
            fringes.append(np.zeros(0, dtype=np.int64))
            continue
        c0 = blk.first_local_col
        c1 = c0 + blk.on_proc_num_cols
        gc = np.asarray(halo_a[sdx][1], dtype=np.int64)
        cmap = wanted[sdx]
        rem = gc[(gc < c0) | (gc >= c1)]
        if len(cmap) and len(rem):
            pos = np.clip(np.searchsorted(cmap, rem), 0, len(cmap) - 1)
            rem = rem[cmap[pos] != rem]
        fringes.append(np.unique(rem))
    if with_fringe:
        fr_states = tr.fetch_ids(
            [st.astype(np.float64) for st in local_states], fringes)
        fr_cid = tr.fetch_ids(
            [ci.astype(np.float64) for ci in local_cid], fringes)

    out = []
    for sdx, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        son, soff = s_shards[sdx].on_proc, s_shards[sdx].off_proc
        n, h = on.n_rows, len(wanted[sdx])
        c0 = blk.first_local_col
        c1 = c0 + on.n_cols
        cmap = wanted[sdx]
        fr = fringes[sdx]
        f = len(fr)
        dummy = n + h + f

        def remap(gcols, n=n, h=h, c0=c0, c1=c1, cmap=cmap, fr=fr,
                  dummy=dummy):
            gcols = np.asarray(gcols, dtype=np.int64)
            outc = np.full(len(gcols), dummy, dtype=np.int64)
            loc = (gcols >= c0) & (gcols < c1)
            outc[loc] = gcols[loc] - c0
            rem = ~loc
            if rem.any() and len(cmap):
                pos = np.clip(np.searchsorted(cmap, gcols), 0,
                              len(cmap) - 1)
                hit = rem & (cmap[pos] == gcols)
                outc[hit] = n + pos[hit]
                rem = rem & ~hit
            if rem.any() and len(fr):
                pos = np.clip(np.searchsorted(fr, gcols), 0, len(fr) - 1)
                hit = rem & (fr[pos] == gcols)
                outc[hit] = n + h + pos[hit]
            return outc

        # --- local rows: on entries then off entries (sorted layout) ---
        non = np.diff(on.indptr)
        noff = np.diff(off.indptr)
        tot_loc = non + noff
        ip_loc = np.concatenate(([0], np.cumsum(tot_loc)))
        nnz_loc = int(ip_loc[-1])
        idx_loc = np.empty(nnz_loc, dtype=np.int64)
        dat_loc = np.empty(nnz_loc)
        str_loc = np.zeros(nnz_loc, dtype=np.int64)
        if on.nnz:
            dst_on = (np.repeat(ip_loc[:-1], non)
                      + (np.arange(on.nnz) - np.repeat(on.indptr[:-1],
                                                       non)))
            idx_loc[dst_on] = on.indices
            dat_loc[dst_on] = on.data
            # strong flags: S on-block pattern, diagonal excluded
            rows_on = on.row_ids()
            s_rows_on = son.row_ids()
            sk = s_rows_on * np.int64(G) + son.indices
            sk = sk[son.indices != s_rows_on]
            ak = rows_on * np.int64(G) + on.indices
            str_loc[dst_on] = np.isin(ak, sk).astype(np.int64)
        if off.nnz:
            dst_off = (np.repeat(ip_loc[:-1] + non, noff)
                       + (np.arange(off.nnz)
                          - np.repeat(off.indptr[:-1], noff)))
            idx_loc[dst_off] = off.indices + n
            dat_loc[dst_off] = off.data
            # off blocks of A and S carry DIFFERENT condensed maps:
            # match by global column id
            rows_off = off.row_ids()
            amap_g = cmap[off.indices]
            smap = np.asarray(s_shards[sdx].off_proc_column_map)
            s_rows_off = soff.row_ids()
            sko = s_rows_off * np.int64(G) + (smap[soff.indices]
                                              if soff.nnz else 0)
            ako = rows_off * np.int64(G) + amap_g
            str_loc[dst_off] = np.isin(ako, sko).astype(np.int64)

        # --- halo rows: remap + stable per-row sort --------------------
        hi_a, hc_a, hv_a = halo_a[sdx]
        hi_s, hc_s, _ = halo_s[sdx]
        rows_h = np.repeat(np.arange(h), np.diff(hi_a))
        ec = remap(hc_a)
        order = np.lexsort((ec, rows_h)) if len(ec) else \
            np.zeros(0, dtype=np.int64)
        # strong flags by global id against the halo S pattern minus the
        # row's own diagonal
        rows_hs = np.repeat(np.arange(h), np.diff(hi_s))
        sk_h = rows_hs * np.int64(G) + hc_s
        sk_h = sk_h[hc_s != (cmap[rows_hs] if h else 0)]
        ak_h = rows_h * np.int64(G) + hc_a
        str_h = np.isin(ak_h, sk_h).astype(np.int64)

        N = n + h + f + 1  # + empty fringe rows + dummy row
        ext_indptr = np.zeros(N + 1, dtype=np.int64)
        ext_indptr[1:n + 1] = ip_loc[1:]
        ext_indptr[n + 1:n + h + 1] = nnz_loc + (hi_a[1:] - hi_a[0])
        ext_indptr[n + h + 1:] = ext_indptr[n + h]
        ext_indices = np.concatenate([idx_loc, ec[order]])
        ext_data = np.concatenate([dat_loc, hv_a[order]])
        ext_strong = np.concatenate([str_loc, str_h[order]])

        ext_states = np.concatenate([
            np.asarray(local_states[sdx], dtype=np.int64),
            halo_states[sdx].astype(np.int64),
            (fr_states[sdx].astype(np.int64) if with_fringe and f
             else np.zeros(0, dtype=np.int64)),
            [int(U)]])
        ext_cid = np.concatenate([
            local_cid[sdx], halo_cid[sdx].astype(np.int64),
            (fr_cid[sdx].astype(np.int64) if with_fringe and f
             else np.zeros(0, dtype=np.int64)),
            [-1]])
        out.append(dict(indptr=ext_indptr, indices=ext_indices,
                        data=ext_data, strong=ext_strong,
                        states=ext_states, cid=ext_cid, n=n, N=N))
    return out, n_coarse


def _dist_interp_from_systems(a, systems, n_coarse, kernel, assemble):
    """Run a native interpolation kernel per shard over the extended
    systems and keep the local rows; assemble or return per-shard."""
    shards = a.shards()
    rows_g, cols_g, vals_g = [], [], []
    for sdx, blk in enumerate(shards):
        sy = systems[sdx]
        n = sy["n"]
        if kernel == "mod_classical":
            rr, cc, vv = native.mod_classical_interp(
                sy["indptr"], sy["indices"], sy["data"], sy["strong"],
                sy["states"])
        else:
            idx = sy["indices"]
            strong = sy["strong"].astype(bool)
            rows_all = np.repeat(np.arange(sy["N"]),
                                 np.diff(sy["indptr"]))
            s_cnt = np.bincount(rows_all[strong], minlength=sy["N"])
            strong_f = strong & (sy["states"][idx] == int(F))
            bound = int(sy["N"] + s_cnt.sum()
                        + s_cnt[idx[strong_f]].sum()) + 1
            rr, cc, vv = native.extended_interp(
                sy["indptr"], sy["indices"], sy["data"], sy["strong"],
                sy["states"], bound)
        keep = rr < n
        r0 = blk.first_local_row if assemble else 0
        if assemble:
            rows_g.append(rr[keep] + r0)
            cols_g.append(sy["cid"][cc[keep]])
            vals_g.append(vv[keep])
        else:
            g = sp.csr_matrix(
                (vv[keep], (rr[keep], sy["cid"][cc[keep]])),
                shape=(n, n_coarse))
            g.sum_duplicates()
            g.sort_indices()
            rows_g.append(CSRMatrix.from_scipy(g))
    if not assemble:
        return rows_g, n_coarse
    g = sp.csr_matrix(
        (np.concatenate(vals_g),
         (np.concatenate(rows_g), np.concatenate(cols_g))),
        shape=(a.global_num_rows, n_coarse))
    g.sum_duplicates()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def dist_mod_classical_interpolation(a: ParCSRMatrix, s_par: ParCSRMatrix,
                                     states_global,
                                     tr: Optional[Transport] = None,
                                     assemble: bool = True):
    """Distributed modified classical interpolation
    (par_interpolation.cpp:1012-1474, helper communicate(A,S,states)
    :30-142): each shard fetches the halo rows of A and the S pattern
    for its off_proc columns, builds an extended local matrix
    [local rows | halo rows] over the extended column space
    {local cols} + {halo cols} + {unknown fringe}, and runs the same
    row algorithm. Unknown distance-2 fringe columns map to a dummy
    Unassigned node, which the algorithm never reads through.

    Per-row arithmetic is identical to the host-global version; only
    in-row accumulation order differs (local-then-halo instead of
    global-ascending), so values match to roundoff."""
    tr = tr or InProcessTransport(a)
    systems, n_coarse = _dist_extended_system(a, s_par, states_global,
                                              tr, with_fringe=False)
    return _dist_interp_from_systems(a, systems, n_coarse,
                                     "mod_classical", assemble)


def dist_extended_interpolation(a: ParCSRMatrix, s_par: ParCSRMatrix,
                                states_global,
                                tr: Optional[Transport] = None,
                                assemble: bool = True):
    """Distributed extended+i (distance-2) interpolation
    (par_interpolation.cpp:301-1010): same extended system as
    mod-classical PLUS real fringe columns — a strong halo F-neighbor's
    coarse neighbors can live two shards away, so their CF states and
    coarse ids are fetched by global id (one fetch_ids round). The
    kernel never reads through fringe ROWS (extended+i only opens rows
    of distance-1 strong F neighbors, which are local or halo), so
    fringe rows stay empty.

    Bit-matches the host-global extended_interpolation up to in-row
    accumulation order (local-then-halo-then-fringe vs
    global-ascending); values agree to roundoff."""
    tr = tr or InProcessTransport(a)
    systems, n_coarse = _dist_extended_system(a, s_par, states_global,
                                              tr, with_fringe=True)
    return _dist_interp_from_systems(a, systems, n_coarse, "extended",
                                     assemble)


def _reset_boundaries(s_par: ParCSRMatrix, states: List[np.ndarray],
                      tr: Transport) -> List[np.ndarray]:
    """Reset shard-boundary rows to Unassigned
    (par_cf_splitting.cpp:184-207): a row is boundary if its S row has
    off_proc entries or a remote row strongly depends on it. Takes and
    returns per-LOCAL-shard state arrays."""
    states = [np.asarray(st, dtype=np.int64).copy() for st in states]
    out_deps = []
    for s, blk in enumerate(s_par.shards()):
        h = len(blk.off_proc_column_map)
        dep = np.zeros(h)
        if blk.off_proc.nnz:
            dep[np.unique(blk.off_proc.indices)] = 1.0
        out_deps.append(dep)
    referenced = tr.reduce(out_deps, op="max", init=0.0)
    for s, blk in enumerate(s_par.shards()):
        n = blk.on_proc.n_rows
        boundary = np.zeros(n, dtype=bool)
        if blk.off_proc.nnz:
            boundary[np.unique(blk.off_proc.row_ids())] = True
        boundary |= referenced[s][:n] > 0.5
        sl = states[s]
        sl[boundary & (sl != int(NO_NBR))] = int(U)
    return states


def _dist_rs_on_proc(s_par: ParCSRMatrix,
                     second_pass: bool) -> List[np.ndarray]:
    """Classical RS pass(es) on each shard's on_proc block only
    (par_cf_splitting.cpp split_falgout/split_hmis interiors). Returns
    per-LOCAL-shard state arrays."""
    out = []
    for s, blk in enumerate(s_par.shards()):
        on = blk.on_proc
        pat = _pattern(on)
        st = set_initial_states(on, pat)
        # rows with ONLY off_proc strong entries still have neighbors
        if blk.off_proc.nnz:
            has_off = np.zeros(on.n_rows, dtype=bool)
            has_off[np.unique(blk.off_proc.row_ids())] = True
            st[(st == int(NO_NBR)) & has_off] = int(U)
        out.append(np.asarray(split_rs(on, st, pat,
                                       second_pass=second_pass)))
    return out


def dist_split_falgout(s_par: ParCSRMatrix, rand_vals: np.ndarray,
                       tr: Optional[Transport] = None) -> np.ndarray:
    """Distributed Falgout (par_cf_splitting.cpp:103-126): full RS on
    each shard's interior, boundary rows re-decided by distributed CLJP.
    Like the reference, the result depends on the partition (interior
    RS is per-shard); at 1 shard it equals the global Falgout."""
    tr = tr or InProcessTransport(s_par)
    states = _dist_rs_on_proc(s_par, second_pass=True)
    states = _reset_boundaries(s_par, states, tr)
    return dist_split_cljp(s_par, rand_vals, states0=states, tr=tr)


def dist_split_hmis(s_par: ParCSRMatrix, rand_vals: np.ndarray,
                    tr: Optional[Transport] = None) -> np.ndarray:
    """Distributed HMIS (par_cf_splitting.cpp:142-163): RS first pass on
    the interior, boundary re-decided by distributed PMIS."""
    tr = tr or InProcessTransport(s_par)
    states = _dist_rs_on_proc(s_par, second_pass=False)
    states = _reset_boundaries(s_par, states, tr)
    return dist_split_pmis(s_par, rand_vals, states0=states, tr=tr)


# --- smoothed aggregation stages (aggregation/par_mis.cpp,
# --- par_aggregate.cpp equivalents) -----------------------------------------

def dist_mis2(s_par: ParCSRMatrix, rand_vals: np.ndarray,
              max_rounds: int = 10000,
              tr: Optional[Transport] = None) -> np.ndarray:
    """Distributed MIS(2) (aggregation/par_mis.cpp:216-655): Luby-style
    with random weights; the distance-2 competition reads prefetched halo
    S row patterns plus fetched fringe ids (the reference's
    comm_coarse_dist1 bookkeeping). Each round's steps run in the native
    kernels, in place on the shard's states."""
    tr = tr or InProcessTransport(s_par)
    shards = s_par.shards()

    r_loc = [np.asarray(rv, dtype=np.float64)
             for rv in _per_shard_rows(rand_vals, shards)]
    halo_r = tr.fetch(r_loc)
    wanted = [np.asarray(blk.off_proc_column_map) for blk in shards]
    halo_pat = tr.fetch_rows(s_par, wanted)
    # fringe: global cols referenced by halo rows (distance-2 data)
    fringe = [np.unique(hp[1]) for hp in halo_pat]
    fringe_r = tr.fetch_ids(r_loc, fringe)

    blk64 = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        n = on.n_rows
        onm = sp.csr_matrix((np.ones(on.nnz), on.indices, on.indptr),
                            shape=(n, on.n_cols))
        onm.sort_indices()
        offm = sp.csr_matrix((np.ones(off.nnz), off.indices, off.indptr),
                             shape=(n, max(1, len(wanted[s]))))
        offm.sort_indices()
        blk64.append(tuple(np.asarray(x, dtype=np.int64) for x in (
            onm.indptr, onm.indices, offm.indptr, offm.indices)))

    local_states = [np.full(len(b[0]) - 1, int(U), dtype=np.int64)
                    for b in blk64]

    def halo_states():
        return tr.fetch([st.astype(np.float64) for st in local_states])

    def fringe_states():
        return tr.fetch_ids([st.astype(np.float64) for st in local_states],
                            fringe)

    for _ in range(max_rounds):
        if tr.allreduce_sum(
                [int(np.count_nonzero((st == int(U)) | (st == int(TMP))))
                 for st in local_states]) == 0:
            break
        # step 1: TMP if no D-out-neighbour (r[v] > r[w]) is U or > SEL
        halo_st = halo_states()
        for s, st in enumerate(local_states):
            native.dist_mis2_step1(*blk64[s], r_loc[s], halo_r[s],
                                   halo_st[s].astype(np.int64), st)

        # step 2: distance-2 competition (the halo's fresh TMP states)
        halo_st2, fringe_st2 = halo_states(), fringe_states()
        for s, st in enumerate(local_states):
            hi, hc, _ = halo_pat[s]
            native.dist_mis2_step2(
                len(wanted[s]), *blk64[s], hi, hc, r_loc[s], halo_r[s],
                halo_st2[s].astype(np.int64), fringe[s],
                fringe_st2[s].astype(np.int64), fringe_r[s], st)

        # steps 3+4: unselect U nodes adjacent to a NEW_S or to a node
        # that points at a NEW_S
        halo_st3, fringe_st3 = halo_states(), fringe_states()
        for s, st in enumerate(local_states):
            hi, hc, _ = halo_pat[s]
            native.dist_mis2_steps34(
                len(wanted[s]), *blk64[s], hi, hc,
                halo_st3[s].astype(np.int64), fringe[s],
                fringe_st3[s].astype(np.int64), st)

        # step 5: finalize (TMP persists across rounds, mis.cpp:316-325)
        for st in local_states:
            st[st == int(NEW_C)] = int(S_)
            st[st == int(NEW_U)] = int(F)

    return tr.allgather_concat(local_states)


def dist_aggregate(a: ParCSRMatrix, s_par: ParCSRMatrix, states_global,
                   rand_vals: Optional[np.ndarray] = None,
                   tr: Optional[Transport] = None):
    """Distributed aggregation (aggregation/par_aggregate.cpp:7-187):
    MIS roots seed aggregates (globally numbered by root rank), pass 1
    joins the first root neighbour in GLOBAL column order, pass 2 joins
    the strongest assigned neighbour (|a_ij| + r[col]), non-cascading.
    Returns (number of aggregates, aggregate of every row)."""
    tr = tr or InProcessTransport(s_par)
    shards_s = s_par.shards()
    shards_a = a.shards()

    local_states = _per_shard_rows(states_global, shards_s)
    root_counts = [int(np.count_nonzero(st > 0)) for st in local_states]
    starts = tr.exscan_sum(root_counts)
    n_aggs = int(tr.allreduce_sum(root_counts))
    local_agg = []
    for st, a0 in zip(local_states, starts):
        agg = np.full(len(st), -1, dtype=np.int64)
        roots = np.nonzero(st > 0)[0]
        agg[roots] = int(a0) + np.arange(len(roots))
        local_agg.append(agg)
    r_rows = _per_shard_rows(rand_vals, shards_s)
    r_loc = [(np.asarray(r_rows[s], dtype=np.float64)
              if r_rows is not None else np.zeros(len(local_states[s])))
             for s in range(len(shards_s))]
    halo_r = tr.fetch(r_loc)

    # pass 1: first root neighbour in global column order
    halo_st = tr.fetch([st.astype(np.float64) for st in local_states])
    halo_agg = tr.fetch([ag.astype(np.float64) for ag in local_agg])
    for s, blk in enumerate(shards_s):
        on, off = blk.on_proc, blk.off_proc
        native.dist_aggregate_pass1(
            blk.first_local_col, on.indptr, on.indices, off.indptr,
            off.indices, blk.off_proc_column_map, local_states[s],
            halo_st[s].astype(np.int64), halo_agg[s].astype(np.int64),
            local_agg[s])

    # pass 2: strongest assigned neighbour, non-cascading
    halo_agg2 = tr.fetch([ag.astype(np.float64) for ag in local_agg])
    for s, blk in enumerate(shards_s):
        on, off = blk.on_proc, blk.off_proc
        aon, aoff = shards_a[s].on_proc, shards_a[s].off_proc
        native.dist_aggregate_pass2(
            on.indptr, on.indices, off.indptr, off.indices, aon.indptr,
            aon.indices, aon.data, aoff.indptr, aoff.indices, aoff.data,
            shards_a[s].off_proc_column_map, blk.off_proc_column_map,
            r_loc[s], halo_r[s], halo_agg2[s].astype(np.int64),
            local_agg[s])
    # decode pass 2 (aggregate.cpp:60-95, with its no-neighbour quirk:
    # best_agg = -1 encodes to aggregate 0)
    for agg in local_agg:
        neg = agg < 0
        agg[neg] = -(agg[neg] + 1)

    return n_aggs, tr.allgather_concat(local_agg)


def dist_fit_candidates(a: ParCSRMatrix, n_aggs: int, aggregates_global, b,
                        tol: float = 1e-10,
                        tr: Optional[Transport] = None,
                        assemble: bool = True):
    """Distributed tentative prolongator, one candidate
    (par_candidates.cpp:7-210): aggregates may span shards, so the
    per-aggregate norms reduce over an n_aggs-sized allreduce. Returns
    (T, R coarse candidate norms); ``assemble=False`` gives
    per-LOCAL-shard T row blocks."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()

    agg_l = _per_shard_rows(aggregates_global, shards)
    b_l = _per_shard_rows(b, shards)
    partial = np.zeros(n_aggs)
    for agg, bb in zip(agg_l, b_l):
        np.add.at(partial, agg, bb ** 2)       # this process's partial
    norms = np.sqrt(tr.allreduce_vec([partial]))
    ok = norms > norms * tol   # per-column threshold as in candidates.cpp
    blocks = []
    for agg, bb in zip(agg_l, b_l):
        vals = np.where(ok[agg],
                        bb / np.where(norms[agg] == 0.0, 1.0, norms[agg]),
                        0.0)
        n = len(agg)
        t = sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, n_aggs))
        t.sort_indices()
        blocks.append(CSRMatrix.from_scipy(t))
    R = np.where(ok, norms, 0.0)
    if not assemble:
        return blocks, R
    g = sp.vstack([t.to_scipy() for t in blocks]).tocsr()
    g.sort_indices()
    return CSRMatrix.from_scipy(g), R


def dist_jacobi_prolongation(a: ParCSRMatrix, t, omega: float = 4.0 / 3.0,
                             num_smooth_steps: int = 1,
                             tr: Optional[Transport] = None,
                             assemble: bool = True):
    """Distributed P = (I - w D~^{-1} A)^k T (par_prolongation.cpp:8-186):
    per shard the |row sum| weights are local (the full on + off row), and
    each smoothing step fetches the halo rows of the current P for the
    local product. ``t``: global T or per-LOCAL-shard row blocks."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()
    p_blocks = _matrix_rows(t, shards)
    nc = p_blocks[0].n_cols
    wanted = [np.asarray(blk.off_proc_column_map) for blk in shards]

    for _ in range(num_smooth_steps):
        halo_rows = tr.fetch_rows(p_blocks, wanted,
                                  row_bounds=a.partition.row_bounds)
        out_parts = []
        for s, blk in enumerate(shards):
            on, off = blk.on_proc, blk.off_proc
            n = on.n_rows
            absum = (np.bincount(on.row_ids(), weights=np.abs(on.data),
                                 minlength=n)
                     + (np.bincount(off.row_ids(), weights=np.abs(off.data),
                                    minlength=n) if off.nnz else 0.0))
            inv = np.where(absum != 0.0, omega / np.abs(absum), 0.0)
            p_loc = p_blocks[s].to_scipy()
            hi, hc, hv = halo_rows[s]
            p_halo = sp.csr_matrix((hv, hc, hi), shape=(len(wanted[s]), nc))
            a_on = sp.csr_matrix((on.data, on.indices, on.indptr),
                                 shape=(n, on.n_cols))
            a_off = sp.csr_matrix((off.data, off.indices, off.indptr),
                                  shape=(n, max(1, len(wanted[s]))))
            ap = a_on @ p_loc + (a_off @ p_halo if off.nnz else 0.0)
            ap = sp.diags(inv) @ ap
            out = (p_loc - ap).tocsr()
            out.sum_duplicates()
            out.data[np.abs(out.data) <= ZERO_TOL] = 0.0
            out.eliminate_zeros()
            out.sort_indices()
            out_parts.append(out)
        p_blocks = [CSRMatrix.from_scipy(o) for o in out_parts]
    if not assemble:
        return p_blocks
    g = sp.vstack([pb.to_scipy() for pb in p_blocks]).tocsr()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def dist_symmetric_strength(a: ParCSRMatrix, theta: float = 0.25,
                            tr: Optional[Transport] = None):
    """Distributed symmetric (SA) strength (par_strength.cpp:347-540): an
    off-diagonal entry is kept if it passes its row's threshold OR its
    column's row threshold; the thresholds of remote columns arrive in one
    halo fetch. Returns per-shard (on_mask, off_mask) keep-masks."""
    tr = tr or InProcessTransport(a)
    shards = a.shards()

    def diag_sign(on):
        rows_on = on.row_ids()
        is_diag = on.indices == rows_on
        dloc = np.zeros(on.n_rows)
        dloc[rows_on[is_diag]] = on.data[is_diag]
        return rows_on, is_diag, dloc < 0.0

    # pass 1: per-row threshold theta * (max|neg diag| / min) off-diag
    local_thr = []
    for blk in shards:
        on, off = blk.on_proc, blk.off_proc
        n = on.n_rows
        rows_on, is_diag, neg = diag_sign(on)
        rows_off = off.row_ids()
        mn = np.full(n, np.inf)
        mx = np.full(n, -np.inf)
        sel = ~is_diag
        np.minimum.at(mn, rows_on[sel], on.data[sel])
        np.maximum.at(mx, rows_on[sel], on.data[sel])
        if off.nnz:
            np.minimum.at(mn, rows_off, off.data)
            np.maximum.at(mx, rows_off, off.data)
        local_thr.append(np.where(neg, mx, mn) * theta)
    halo_thr = tr.fetch(local_thr)
    local_neg = [diag_sign(blk.on_proc)[2].astype(np.float64)
                 for blk in shards]
    halo_neg = tr.fetch(local_neg)

    def strong(vals, t, ng):
        return np.where(ng, vals > t, vals < t)

    masks = []
    for s, blk in enumerate(shards):
        on, off = blk.on_proc, blk.off_proc
        rows_on, rows_off = on.row_ids(), off.row_ids()
        is_diag = on.indices == rows_on
        thr = local_thr[s]
        neg = local_neg[s] > 0.5
        s_row_on = strong(on.data, thr[rows_on], neg[rows_on])
        s_col_on = strong(on.data, thr[on.indices], neg[on.indices])
        on_mask = is_diag | (~is_diag & (s_row_on | s_col_on))
        if off.nnz:
            s_row_off = strong(off.data, thr[rows_off], neg[rows_off])
            s_col_off = strong(off.data, halo_thr[s][off.indices],
                               halo_neg[s][off.indices] > 0.5)
            off_mask = s_row_off | s_col_off
        else:
            off_mask = np.zeros(0, dtype=bool)
        masks.append((on_mask, off_mask))
    return masks
