"""Blocked (BSR) AMG: nodal hierarchy and block-ELL device solve (copy of
raptor_tpu.multilevel.bsr_hierarchy).

The reference's ParBSR path (core/par_matrix.hpp:613-699, CSR->BSR
redistribution par_matrix.cpp:872-997, blocked SpMV spmv.cpp:128) treats
a system with ``b`` dofs per node as a matrix of b x b dense blocks. The
AMG analog is NODAL coarsening: condense each b x b block to its Frobenius
norm, make the nodal graph an M-matrix, run the scalar classical pipeline
(strength -> CF split -> interpolation) on it, and interpolate each
component through its own nodal prolongator on the common coarse grid, so
every level's operator keeps exact b x b block structure. With
``setup_mode = "distributed"`` each level extends through the per-shard
stages over a transport (``bsr_extend_distributed``, which
``comm.spmd.spmd_bsr_setup`` runs too).

Device side: each level's operator is a block-ELL ``DeviceParBSR``
(``device.bsr``), smoothing is block Chebyshev (or damped block Jacobi),
and the transfer operators act per component through the scalar nodal
device matrices of ``device.par``, whose SpMVs launch the CUDA kernels.
The solve is a Python loop that reads the residual norm back once per
cycle. ``precond_pack`` makes the blocked V-cycle a preconditioner for the
scalar Krylov solvers (PCG on BSR operators).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.comm.transport import InProcessTransport
from raptor_tpu_torch.core.types import (CFState, CoarsenType, InterpType,
                                         RelaxType, StrengthType)
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.bsr import DeviceParBSR, bsr_spmv, device_put_bsr
from raptor_tpu_torch.device.par import (
    DeviceParCSR, bdia_tile_share, device_put_matrix, spmv)
from raptor_tpu_torch.multilevel.device_hierarchy import _coarse_plumbing
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.multilevel.par_multilevel import (
    ParMultilevel, ParRugeStubenSolver, check_setup_mode)
from raptor_tpu_torch.profiling.timers import Profiler
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf
from raptor_tpu_torch.ruge_stuben import par_setup as ps
from raptor_tpu_torch.ruge_stuben.interpolation import (
    direct_interpolation, mod_classical_interpolation)
from raptor_tpu_torch.ruge_stuben.strength import strength
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights


def nodal_matrix(a: CSRMatrix, b: int, first_node: int = 0) -> CSRMatrix:
    """Condense b x b blocks to an M-matrix nodal graph: diagonal block
    -> +||B||_F, off-diagonal -> -||B||_F (the blocked-systems strength
    convention; the scalar classical pipeline then applies unchanged).

    ``first_node``: global node id of row 0 (for row blocks whose columns
    are global)."""
    assert a.n_rows % b == 0 and a.n_cols % b == 0
    gb = a.to_scipy().tobsr(blocksize=(b, b))
    norms = np.sqrt((np.asarray(gb.data) ** 2).sum(axis=(1, 2)))
    nb = a.n_rows // b
    rows = np.repeat(np.arange(nb), np.diff(gb.indptr))
    sign = np.where(gb.indices == rows + first_node, 1.0, -1.0)
    m = sp.csr_matrix((norms * sign, gb.indices, gb.indptr),
                      shape=(nb, a.n_cols // b))
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def expand_prolongator(p_nodal: CSRMatrix, b: int) -> CSRMatrix:
    """P = P_n (x) I_b (block-diagonal expansion, scalar CSR)."""
    pk = sp.kron(p_nodal.to_scipy(), sp.identity(b, format="csr"),
                 format="csr")
    pk.sort_indices()
    return CSRMatrix.from_scipy(pk)


def block_partition(n_scalar: int, m_scalar: int, b: int,
                    n_shards: int) -> Partition:
    """Scalar partition whose bounds land on block boundaries."""
    bpart = Partition.create(n_scalar // b, m_scalar // b, n_shards)
    return Partition(n_scalar, m_scalar, n_shards,
                     np.asarray(bpart.row_bounds) * b,
                     np.asarray(bpart.col_bounds) * b)


def component_block(g_s: CSRMatrix, b: int, c: int) -> CSRMatrix:
    """Per-shard component coupling submatrix A_c = A[c::b, c::b]
    restricted to this shard's rows: local node rows, GLOBAL node cols.
    The shard's first scalar row is block-aligned, so local scalar row i
    belongs to component (i % b)."""
    m = g_s.to_scipy()
    keep = m[c::b, :].tocoo()
    sel = (keep.col % b) == c
    out = sp.csr_matrix(
        (keep.data[sel], (keep.row[sel], keep.col[sel] // b)),
        shape=(keep.shape[0], g_s.n_cols // b))
    out.sum_duplicates()
    out.sort_indices()
    return CSRMatrix.from_scipy(out)


def bsr_extend_distributed(a: ParCSRMatrix, b: int, weights: np.ndarray,
                           coarsen: CoarsenType, interp: InterpType,
                           theta: float, make_transport,
                           strength_type=None,
                           timers: Optional[Profiler] = None):
    """One blocked-AMG level extension over the transport: nodal
    condensation, strength, CF split, per-component interpolation and the
    Galerkin product all run on per-shard blocks and collectives, with no
    global matrix (the distributed twin of
    ``ParBSRRugeStubenSolver.extend_hierarchy``, under the same phase
    names in ``timers``). Classical or symmetric nodal strength; CLJP,
    PMIS, HMIS or (for RS and Falgout) the Falgout hybrid; modified
    classical interpolation only, as the JAX package's.

    Returns (scalar P row blocks per LOCAL shard, [b] lists of the nodal
    component P row blocks per LOCAL shard, states, scalar coarse row
    blocks per LOCAL shard, scalar coarse partition)."""
    if interp != InterpType.ModClassical:
        raise NotImplementedError(
            f"the distributed blocked setup runs modified classical "
            f"interpolation only, as the JAX package's, not {interp}")
    if strength_type not in (None, StrengthType.Classical,
                             StrengthType.Symmetric):
        raise NotImplementedError(
            f"distributed blocked setup: strength_type {strength_type}")
    timers = timers or Profiler("raptor.setup.")
    part = a.partition
    S = part.n_shards
    fs = a.first_shard
    shards = a.shards()
    n_nodes = part.global_num_rows // b
    ncols = part.global_num_cols
    part_nodes = Partition(n_nodes, n_nodes, S,
                           np.asarray(part.row_bounds) // b,
                           np.asarray(part.col_bounds) // b)

    g_blocks = [blk.global_cols_csr(ncols) for blk in shards]
    with timers.phase("strength"):
        # per-shard nodal condensation: scalar rows (global cols) -> nodal
        # rows with global nodal cols
        nod_blocks = [nodal_matrix(g, b, int(part.row_bounds[fs + i]) // b)
                      for i, g in enumerate(g_blocks)]
        nod_par = ParCSRMatrix.from_local_rows(nod_blocks, part_nodes,
                                               first_shard=fs)
        tr_n = make_transport(nod_par)
        if strength_type == StrengthType.Symmetric:
            masks = ps.dist_symmetric_strength(nod_par, theta, tr=tr_n)
        else:
            masks = ps.dist_classical_strength(nod_par, theta, tr=tr_n)
        s_n = ps.strength_masks_to_par(nod_par, masks)
    w = weights[:n_nodes]
    with timers.phase("cf_splitting"):
        tr_s = make_transport(s_n)
        if coarsen == CoarsenType.CLJP:
            states = ps.dist_split_cljp(s_n, w, tr=tr_s)
        elif coarsen == CoarsenType.PMIS:
            states = ps.dist_split_pmis(s_n, w, tr=tr_s)
        elif coarsen == CoarsenType.HMIS:
            states = ps.dist_split_hmis(s_n, w, tr=tr_s)
        else:
            states = ps.dist_split_falgout(s_n, w, tr=tr_s)
        states = np.asarray(states)

    with timers.phase("interpolation"):
        # nodal strength patterns per local shard (to mask the components)
        s_pats = []
        for blk in s_n.shards():
            g = blk.global_cols_csr(n_nodes).to_scipy()
            g.data = np.ones_like(g.data)
            s_pats.append(g)
        p_comp_blocks = []
        n_coarse = None
        for c in range(b):
            comp = [component_block(g, b, c) for g in g_blocks]
            sc = [CSRMatrix.from_scipy(
                comp[i].to_scipy().multiply(s_pats[i]).tocsr())
                for i in range(len(comp))]
            a_c = ParCSRMatrix.from_local_rows(comp, part_nodes,
                                               first_shard=fs)
            s_c = ParCSRMatrix.from_local_rows(sc, part_nodes,
                                               first_shard=fs)
            pc_blocks, n_coarse = ps.dist_mod_classical_interpolation(
                a_c, s_c, states, tr=make_transport(a_c), assemble=False)
            p_comp_blocks.append(pc_blocks)

        # block-diagonal scalar P rows per local shard
        p_blocks = []
        for i in range(len(shards)):
            rows, cols, vals = [], [], []
            for c in range(b):
                coo = p_comp_blocks[c][i].to_scipy().tocoo()
                rows.append(coo.row.astype(np.int64) * b + c)
                cols.append(coo.col.astype(np.int64) * b + c)
                vals.append(coo.data)
            pm = sp.csr_matrix(
                (np.concatenate(vals),
                 (np.concatenate(rows), np.concatenate(cols))),
                shape=(shards[i].local_num_rows, n_coarse * b))
            pm.sort_indices()
            p_blocks.append(CSRMatrix.from_scipy(pm))

    # coarse partition: nodal coarse bounds (C-nodes per shard) * b
    csum = np.concatenate([[0], np.cumsum(states == CFState.Selected)])
    cb = csum[np.asarray(part_nodes.row_bounds)].astype(np.int64) * b
    part_c = Partition(n_coarse * b, n_coarse * b, S, cb, cb)
    with timers.phase("RAP"):
        c_blocks = ps.dist_rap(a, p_blocks, tr=make_transport(a),
                               coarse_bounds=cb, assemble=False)
    return p_blocks, p_comp_blocks, states, c_blocks, part_c


def nodal_transfers(ml: "ParBSRRugeStubenSolver",
                    level: int) -> List[ParCSRMatrix]:
    """The nodal component prolongators P_c of ``level``, partitioned by
    the nodes of that level's and the next level's blocked partitions."""
    b = ml.block_size
    p_comps = ml.p_nodals[level]
    part_nodes = Partition(
        p_comps[0].n_rows, p_comps[0].n_cols,
        ml.levels[level].A.partition.n_shards,
        np.asarray(ml.levels[level].A.partition.row_bounds) // b,
        np.asarray(ml.levels[level + 1].A.partition.row_bounds) // b)
    return [ParCSRMatrix(p_c, part_nodes) for p_c in p_comps]


class ParBSRRugeStubenSolver(ParMultilevel):
    """Blocked classical AMG: nodal coarsening on the block-norm graph,
    per-component interpolation, scalar-native Galerkin RAP (the result
    stays block-structured because P is block-diagonal). ``max_coarse``
    counts nodes. ``setup_mode`` "global" or "distributed"
    (``_extend_hierarchy_distributed``)."""

    # RS is split_rs_entry on every level (no switch to Falgout)
    SPLITS = ParRugeStubenSolver.SPLITS

    def __init__(self, block_size: int, strong_threshold: float = 0.0,
                 coarsen_type: CoarsenType = CoarsenType.RS,
                 interp_type: InterpType = InterpType.ModClassical,
                 relax_type: RelaxType = RelaxType.Jacobi,
                 strength_type: StrengthType = StrengthType.Classical):
        super().__init__(strong_threshold, strength_type, relax_type)
        self.block_size = int(block_size)
        self.coarsen_type = coarsen_type
        self.interp_type = interp_type
        self.max_coarse = 50  # nodes
        # per level, the b nodal component prolongators
        self.p_nodals: List[List[CSRMatrix]] = []

    def setup(self, af: ParCSRMatrix) -> None:
        check_setup_mode(self.setup_mode)
        b = self.block_size
        n = af.global_num_rows
        if n % b:
            raise ValueError(f"{n} rows are not a multiple of the block "
                             f"size {b}")
        # re-partition on block boundaries (to_ParBSR redistribution,
        # par_matrix.cpp:872-997)
        part = block_partition(n, af.global_num_cols, b,
                               af.partition.n_shards)
        af = ParCSRMatrix(af.global_csr, part)
        if self.weights is None:
            self.weights = form_rand_weights(n // b, 0)
        self.levels = [Level(A=af.copy())]
        self.p_nodals = []
        self.setup_level_times = []
        while (self.levels[-1].A.global_num_rows // b > self.max_coarse
               and len(self.levels) < self.max_levels):
            before = dict(self.setup_times.times)
            self.extend_hierarchy()
            self.setup_level_times.append({
                k: v - before.get(k, 0.0)
                for k, v in self.setup_times.times.items()
                if v - before.get(k, 0.0) > 0.0})
        self.duplicate_coarse()

    def extend_hierarchy(self) -> None:
        """Shared nodal CF split on the block-norm graph, then PER-COMPONENT
        interpolation weights from each component's own coupling submatrix
        A_c = A[c::b, c::b] masked to the nodal strength pattern, on one
        common nodal coarse grid: P's blocks are diagonal
        (diag(p_0[i,j], ..., p_{b-1}[i,j])), so every Galerkin product
        keeps exact b x b block structure."""
        if self.setup_mode == "distributed":
            return self._extend_hierarchy_distributed()
        b = self.block_size
        a = self.levels[-1].A
        n_nodes = a.global_num_rows // b
        nod = nodal_matrix(a.global_csr, b)
        part_nodes = Partition(
            n_nodes, n_nodes, a.partition.n_shards,
            np.asarray(a.partition.row_bounds) // b,
            np.asarray(a.partition.col_bounds) // b)
        nod_par = ParCSRMatrix(nod, part_nodes)

        with self.setup_times.phase("strength"):
            s_n = strength(nod_par, self.strength_type,
                           self.strong_threshold)
        w = self.weights[:n_nodes]
        with self.setup_times.phase("cf_splitting"):
            if self.coarsen_type in self.SPLITS:
                states = self.SPLITS[self.coarsen_type](s_n, w)
            else:
                states = cf.split_rs_entry(s_n)
            states = np.asarray(states)

        with self.setup_times.phase("interpolation"):
            g = a.global_csr.to_scipy()
            snp = s_n.global_csr.to_scipy()
            snp_pat = sp.csr_matrix(
                (np.ones(snp.nnz), snp.indices, snp.indptr),
                shape=snp.shape)
            interp = (direct_interpolation
                      if self.interp_type == InterpType.Direct
                      else mod_classical_interpolation)
            p_comps = []
            for c in range(b):
                a_c = g[c::b, :][:, c::b].tocsr()
                s_c = a_c.multiply(snp_pat).tocsr()
                s_c.sort_indices()
                p_comps.append(interp(CSRMatrix.from_scipy(a_c),
                                      CSRMatrix.from_scipy(s_c), states))
            self.p_nodals.append(p_comps)
            # block-diagonal assembly: (i*b+c, j*b+c) = p_c[i, j]
            nc = p_comps[0].n_cols
            rows, cols, vals = [], [], []
            for c in range(b):
                coo = p_comps[c].to_scipy().tocoo()
                rows.append(coo.row.astype(np.int64) * b + c)
                cols.append(coo.col.astype(np.int64) * b + c)
                vals.append(coo.data)
            pm = sp.csr_matrix(
                (np.concatenate(vals),
                 (np.concatenate(rows), np.concatenate(cols))),
                shape=(a.global_num_rows, nc * b))
            pm.sort_indices()
            p = CSRMatrix.from_scipy(pm)

        pp = ParCSRMatrix(p, Partition(
            a.global_num_rows, p.n_cols, a.partition.n_shards,
            a.partition.row_bounds,
            block_partition(p.n_cols, p.n_cols, b,
                            a.partition.n_shards).col_bounds))
        self.levels[-1].P = pp

        with self.setup_times.phase("RAP"):
            ap = a.multiply(pp)
            ac = pp.mult_T_mat(ap)
        self.levels.append(Level(A=ac))


    def _extend_hierarchy_distributed(self) -> None:
        """The blocked level extension through ``bsr_extend_distributed``
        over the in-process transport. Every shard is local, so P and the
        coarse operator are assembled for the device layer, and the coarse
        level is re-partitioned evenly on block boundaries (the global
        path's rule, which the blocked packer assumes)."""
        b = self.block_size
        a = self.levels[-1].A
        p_blocks, p_comps, _, c_blocks, part_c = bsr_extend_distributed(
            a, b, self.weights, self.coarsen_type, self.interp_type,
            self.strong_threshold, InProcessTransport,
            strength_type=self.strength_type, timers=self.setup_times)
        part = a.partition
        n_c = int(part_c.global_num_cols)
        part_even = block_partition(n_c, n_c, b, part.n_shards)
        part_p = Partition(part.global_num_rows, n_c, part.n_shards,
                           part.row_bounds, part_even.col_bounds)

        def stack(blocks):
            g = sp.vstack([m.to_scipy() for m in blocks]).tocsr()
            g.sort_indices()
            return CSRMatrix.from_scipy(g)

        self.levels[-1].P = ParCSRMatrix(stack(p_blocks), part_p)
        self.p_nodals.append([stack(p_comps[c]) for c in range(b)])
        self.levels.append(Level(A=ParCSRMatrix(stack(c_blocks),
                                                part_even)))


@dataclasses.dataclass
class BSRDeviceLevel:
    Ab: DeviceParBSR
    inv_diag: torch.Tensor    # [S, RB, b, b] inverted diagonal blocks
    Pn: Optional[Tuple[DeviceParCSR, ...]]   # nodal P_c (None on coarsest)
    PnT: Optional[Tuple[DeviceParCSR, ...]]  # nodal P_c^T
    # Chebyshev interval of D_block^{-1} A (host power iteration)
    cheb_lo: float = 0.0
    cheb_hi: float = 2.0


class BSRDeviceHierarchy:
    """Device solve over a ``ParBSRRugeStubenSolver`` hierarchy: block-ELL
    operators, block-Chebyshev (or damped block-Jacobi) smoothing,
    per-component nodal transfers, redundant dense coarse LU.

    ``device`` defaults to CUDA and raises when CUDA is absent;
    ``lane_pad`` defaults to 128 on CUDA and 1 elsewhere, as in
    ``DeviceHierarchy``. The nodal transfer operators are packed by
    ``device_put_matrix`` without the embedding."""

    def __init__(self, ml: ParBSRRugeStubenSolver, dtype=torch.float64,
                 omega: float = 2.0 / 3.0, sweeps: int = 2,
                 lane_pad: int = None, device="cuda"):
        if ml.levels[0].A.is_local_view:
            raise NotImplementedError(
                "BSRDeviceHierarchy packs the global blocked operators, as "
                "the JAX package's BSRDeviceHierarchy does (it has no "
                "from_spmd either); a local view (one controller's setup, "
                "comm.spmd.spmd_bsr_setup) has no blocked solve across "
                "controllers")
        if ml.tap_amg >= 0:
            raise NotImplementedError(
                f"tap_amg = {ml.tap_amg}: the blocked V-cycle has no "
                f"topology-aware exchange (the JAX package's has none "
                f"either); set tap_amg = -1")
        self.device = dpar.resolve_device(device)
        if lane_pad is None:
            lane_pad = 128 if self.device.type == "cuda" else 1
        self.lane_pad = lane_pad
        self.dtype = dtype
        self.omega = float(omega)
        self.sweeps = int(sweeps)
        b = ml.block_size
        self.b = b
        npdt = dpar._np_dtype(dtype)
        # host seconds of the packing: the blocked operators with their
        # inverted diagonal blocks, the nodal transfers, the Chebyshev
        # intervals
        self.pack_times = Profiler("raptor.pack.")
        put = dict(dtype=dtype, lane_pad=lane_pad, need_transpose=False,
                   device=self.device)

        levels = []
        for i, lvl in enumerate(ml.levels):
            with self.pack_times.phase("blocked"):
                Ab = device_put_bsr(lvl.A, b, b, dtype=dtype,
                                    device=self.device)
                inv = torch.from_numpy(self._inv_diag_blocks(
                    lvl.A, b, Ab.brows_pad).astype(npdt)).to(self.device)
            Pn = PnT = None
            if lvl.P is not None:
                with self.pack_times.phase("transfers"):
                    pars = nodal_transfers(ml, i)
                    Pn = tuple(device_put_matrix(p, **put) for p in pars)
                    PnT = tuple(device_put_matrix(p.transpose(), **put)
                                for p in pars)
            with self.pack_times.phase("chebyshev"):
                lo, hi = self._cheb_interval(lvl.A, b)
            levels.append(BSRDeviceLevel(Ab, inv, Pn, PnT, lo, hi))
        self.levels: Tuple[BSRDeviceLevel, ...] = tuple(levels)

        # redundant coarse LU over the SCALAR coarse operator; scipy's
        # 0-based pivots are sequential row swaps, which
        # torch.linalg.lu_solve numbers from 1
        lu, piv = ml.coarse_lu
        self.lu = torch.from_numpy(np.asarray(lu)).to(self.device, dtype)
        self.piv = torch.from_numpy(
            np.asarray(piv, dtype=np.int32) + 1).to(self.device)
        part_c = ml.levels[-1].A.partition
        gather_idx, coarse_take = _coarse_plumbing(
            part_c, self.levels[-1].Ab.brows_pad * b, 0, part_c.n_shards)
        self.gather_idx = torch.from_numpy(gather_idx).to(self.device)
        self.coarse_take = torch.from_numpy(coarse_take).to(self.device)
        self.row_bounds = ml.levels[0].A.partition.row_bounds
        self._precond = None

    @staticmethod
    def _cheb_interval(a: ParCSRMatrix, b: int):
        """Power-iteration lambda_max of D_block^{-1} A (host), hypre
        interval [0.3 lmax, 1.1 lmax]."""
        g = a.global_csr.to_scipy()
        n = g.shape[0]
        gb = g.tobsr(blocksize=(b, b))
        nb = n // b
        rr = np.repeat(np.arange(nb), np.diff(gb.indptr))
        dblocks = np.zeros((nb, b, b))
        on_diag = gb.indices == rr
        dblocks[rr[on_diag]] = np.asarray(gb.data)[on_diag]
        sing = np.abs(np.linalg.det(dblocks)) < 1e-300
        dblocks[sing] = np.eye(b)
        dinv = np.linalg.inv(dblocks)
        rng = np.random.default_rng(7)
        v = rng.random(n) + 0.1
        v /= np.linalg.norm(v)
        lmax = 1.0
        for _ in range(12):
            w = np.einsum("rij,rj->ri", dinv,
                          (g @ v).reshape(nb, b)).reshape(-1)
            nw = np.linalg.norm(w)
            if nw <= 0:
                break
            lmax, v = nw, w / nw
        return 0.3 * float(lmax), 1.1 * float(lmax)

    @staticmethod
    def _inv_diag_blocks(a: ParCSRMatrix, b: int,
                         rb_pad: int) -> np.ndarray:
        """[S, rb_pad, b, b] inverted diagonal blocks of each shard's block
        rows, identity on the padding."""
        S = a.partition.n_shards
        out = np.zeros((S, rb_pad, b, b))
        out[:, :, np.arange(b), np.arange(b)] = 1.0   # identity padding
        g = a.global_csr.to_scipy()
        for s in range(S):
            r0 = int(a.partition.row_bounds[s])
            r1 = int(a.partition.row_bounds[s + 1])
            nb = (r1 - r0) // b
            dblocks = np.zeros((nb, b, b))
            rows = g[r0:r1].tobsr(blocksize=(b, b))
            rr = np.repeat(np.arange(nb), np.diff(rows.indptr))
            on_diag = rows.indices == rr + r0 // b
            dblocks[rr[on_diag]] = np.asarray(rows.data)[on_diag]
            out[s, :nb] = np.linalg.inv(dblocks)
        return out

    def format_summary(self) -> List[str]:
        """One line per level: its scalar rows and the packed format of each
        component's nodal P_c and P_c^T, with the share of the (plane, row
        block) tiles that a BDIA operator fills."""
        def fmt(M):
            if M.on_format != "bdia":
                return M.on_format
            return f"bdia({bdia_tile_share(M):.1%})"

        lines = []
        for i, lvl in enumerate(self.levels):
            line = f"level {i:2d}: {lvl.Ab.global_num_rows:9d} rows"
            if lvl.Pn is not None:
                line += "".join(
                    f"  Pn{c} {fmt(p)}  PnT{c} {fmt(pt)}"
                    for c, (p, pt) in enumerate(zip(lvl.Pn, lvl.PnT)))
            lines.append(line)
        return lines

    # --- the cycle --------------------------------------------------------------
    def _dinv(self, lvl: BSRDeviceLevel, r: torch.Tensor) -> torch.Tensor:
        S = r.shape[0]
        r2 = r.reshape(S, -1, 1, self.b)
        return (lvl.inv_diag * r2).sum(dim=-1).reshape(S, -1)

    def _block_jacobi(self, lvl: BSRDeviceLevel, x: torch.Tensor,
                      b_vec: torch.Tensor) -> torch.Tensor:
        """Block-Chebyshev smoothing: the scalar Chebyshev recurrence in
        the block-Jacobi-preconditioned operator D_b^{-1} A (degree =
        ``sweeps``); plain damped block Jacobi when sweeps == 1."""
        Ab = lvl.Ab
        if self.sweeps == 1:
            r = b_vec - bsr_spmv(Ab, x)
            return x + self.omega * self._dinv(lvl, r)
        lo, hi = lvl.cheb_lo, lvl.cheb_hi
        th, de = (hi + lo) / 2.0, (hi - lo) / 2.0
        r = b_vec - bsr_spmv(Ab, x)
        p = self._dinv(lvl, r) / th
        x = x + p
        sigma = th / de
        rho = 1.0 / sigma
        for _ in range(1, self.sweeps):
            r = b_vec - bsr_spmv(Ab, x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            p = (rho * rho_new) * p + (2.0 * rho_new / de) * self._dinv(lvl,
                                                                        r)
            x = x + p
            rho = rho_new
        return x

    def _transfer(self, ops, v: torch.Tensor, rb_out: int) -> torch.Tensor:
        """[S, RB_in*b] -> [S, rb_out*b]: each component through ITS nodal
        operator, its input padded to the operator's column space and its
        output cut to ``rb_out`` block rows."""
        S = v.shape[0]
        v2 = v.reshape(S, -1, self.b)
        outs = []
        for c in range(self.b):
            vc = F.pad(v2[:, :, c], (0, ops[c].cols_pad - v2.shape[1]))
            outs.append(spmv(ops[c], vc)[:, :rb_out])
        return torch.stack(outs, dim=2).reshape(S, -1)

    def _restrict(self, PnT, r: torch.Tensor, rb_coarse: int):
        return self._transfer(PnT, r, rb_coarse)

    def _prolong(self, Pn, e: torch.Tensor, rb_fine: int):
        return self._transfer(Pn, e, rb_fine)

    def _coarse_solve(self, b_vec: torch.Tensor) -> torch.Tensor:
        """Gather every shard's coarse rhs and solve densely."""
        bvec = b_vec.reshape(-1)[self.gather_idx]
        y = torch.linalg.lu_solve(self.lu, self.piv, bvec[:, None])[:, 0]
        return y[self.coarse_take]

    def vcycle(self, x: torch.Tensor, b_vec: torch.Tensor,
               level: int = 0) -> torch.Tensor:
        """One blocked V-cycle on stacked [S, RB*b] shard vectors."""
        lvl = self.levels[level]
        if level == len(self.levels) - 1:
            return self._coarse_solve(b_vec)
        x = self._block_jacobi(lvl, x, b_vec)
        r = b_vec - bsr_spmv(lvl.Ab, x)
        rc = self._restrict(lvl.PnT, r, self.levels[level + 1].Ab.brows_pad)
        ec = self.vcycle(torch.zeros_like(rc), rc, level + 1)
        x = x + self._prolong(lvl.Pn, ec, lvl.Ab.brows_pad)
        return self._block_jacobi(lvl, x, b_vec)

    # --- public solve ----------------------------------------------------------
    def vector(self, v: np.ndarray) -> torch.Tensor:
        return dpar.device_put_vector(
            v, self.row_bounds, self.levels[0].Ab.brows_pad * self.b,
            dtype=self.dtype, device=self.device)

    def host(self, v: torch.Tensor) -> np.ndarray:
        return dpar.host_vector(v, self.row_bounds)

    def solve(self, x: torch.Tensor, b_vec: torch.Tensor, tol: float = 1e-7,
              max_iter: int = 100):
        """Iterated V-cycles to ``tol`` relative residual: (x, residual
        history padded with -1, cycles)."""
        A0 = self.levels[0].Ab
        b_norm = float(dpar.norm(b_vec))
        b_norm = b_norm if b_norm > 1e-300 else 1.0

        def rel(x):
            return float(dpar.norm(b_vec - bsr_spmv(A0, x))) / b_norm

        hist = np.full(max_iter + 1, -1.0)
        hist[0] = rr = rel(x)
        k = 0
        while rr > tol and k < max_iter:
            x = self.vcycle(x, b_vec)
            rr = rel(x)
            k += 1
            hist[k] = rr
        return x, hist, k

    def precond_pack(self):
        """The blocked V-cycle as the preconditioner ``precond(x0, r)`` of
        the scalar Krylov solvers, cached on the hierarchy. Their [S, R]
        vectors of the scalar level-0 A (``ml.levels[0].A``, whose
        partition is the blocked one) hold the BSR [S, RB*b] layout in
        their first RB*b entries; the cycle runs in the hierarchy's dtype
        and the correction is cast back to ``r.dtype``."""
        if self._precond is None:
            nb = self.levels[0].Ab.brows_pad * self.b

            def precond(x0: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                rb = r[:, :nb].to(self.dtype)
                out = self.vcycle(torch.zeros_like(rb), rb)
                return F.pad(out, (0, r.shape[1] - nb)).to(r.dtype)
            self._precond = precond
        return self._precond
