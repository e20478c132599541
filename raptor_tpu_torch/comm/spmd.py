"""Whole-hierarchy SPMD AMG setup (copy of raptor_tpu.comm.spmd): every
rank builds the LOCAL slice of every level, and no process holds a global
matrix.

The per-rank equivalent of ``ParRugeStubenSolver::setup``
(ruge_stuben/par_ruge_stuben_solver.hpp:32-177 over MPI), of the smoothed
aggregation setup (aggregation/par_smoothed_aggregation_solver.hpp:
14-150) and of the blocked setup: strength -> coarsening -> interpolation
-> Galerkin product, looped to the coarsest level, entirely over
``Transport`` collectives (``ruge_stuben.par_setup``). Only O(global n)
vectors (CF states, weights) are replicated per rank, as the reference's
per-rank state arrays are; matrices stay distributed throughout. The
coarsest operator (at most ``max_coarse`` rows) is allgathered and
LU-factored on every rank (duplicate_coarse, par_multilevel.hpp:223-333).

``multilevel.device_hierarchy.DeviceHierarchy.from_spmd`` packs the
result for the device solve. ``make_transport`` binds the rank's
communication: ``comm.transport.InProcessTransport`` (every shard in one
process) or ``comm.multiproc.MultiProcessTransport`` (one shard per
process, over a ``ProcessGroup`` or a ``comm.netgroup.SocketGroup``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.linalg

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import CFState, CoarsenType, InterpType
from raptor_tpu_torch.multilevel.bsr_hierarchy import bsr_extend_distributed
from raptor_tpu_torch.ruge_stuben import par_setup as ps
from raptor_tpu_torch.ruge_stuben.interpolation import filter_interp


@dataclasses.dataclass
class SpmdLevel:
    """One rank's slice of one hierarchy level."""

    a_local: ParCSRMatrix                # local view
    p_blocks: Optional[List[CSRMatrix]]  # this rank's P row blocks (global
                                         # cols), one per local shard
    states: Optional[np.ndarray]         # replicated CF states / MIS roots

    @property
    def p_block(self) -> Optional[CSRMatrix]:
        return None if self.p_blocks is None else self.p_blocks[0]


@dataclasses.dataclass
class SpmdHierarchy:
    levels: List[SpmdLevel]
    coarse_lu: tuple                     # replicated (lu, piv)

    @property
    def num_levels(self) -> int:
        return len(self.levels)


def _coarse_bounds(states: np.ndarray, row_bounds) -> np.ndarray:
    """Coarse row partition: the C-points (roots) each shard owns."""
    sel = np.asarray(states) == CFState.Selected
    csum = np.concatenate([[0], np.cumsum(sel)])
    return csum[np.asarray(row_bounds)].astype(np.int64)


def _coarse_level(a: ParCSRMatrix, c_blocks, n_coarse: int,
                  cb) -> ParCSRMatrix:
    """The next level's local view: this rank's coarse row blocks under
    the coarse partition ``cb``."""
    part_c = Partition(n_coarse, n_coarse, a.partition.n_shards, cb, cb)
    return ParCSRMatrix.from_local_rows(c_blocks, part_c,
                                        first_shard=a.first_shard)


def _finish(levels: List[SpmdLevel], a: ParCSRMatrix,
            make_transport) -> SpmdHierarchy:
    """Append the coarsest level and its redundant dense LU: every rank
    allgathers the (small) coarsest rows and factors them."""
    ncols = a.partition.global_num_cols
    flats = [np.asarray(blk.global_cols_csr(ncols).to_scipy().todense())
             .reshape(-1) for blk in a.shards()]
    full = make_transport(a).allgather_concat(flats)
    coarse_lu = scipy.linalg.lu_factor(full.reshape(a.global_num_rows,
                                                    ncols))
    levels.append(SpmdLevel(a, None, None))
    return SpmdHierarchy(levels, coarse_lu)


def spmd_rs_setup(a_local: ParCSRMatrix, weights: np.ndarray,
                  make_transport,
                  coarsen: CoarsenType = CoarsenType.HMIS,
                  interp: InterpType = InterpType.Extended,
                  theta: float = 0.25, interp_filter: float = 0.3,
                  max_coarse: int = 50,
                  max_levels: int = 25) -> SpmdHierarchy:
    """Build the whole Ruge-Stuben hierarchy rank-locally: classical
    strength, CLJP / PMIS / HMIS / Falgout (RS runs the Falgout hybrid),
    direct, modified-classical or extended+i interpolation (filtered at
    ``interp_filter``, as the reference does under every coarsening).

    ``a_local``: this rank's local-view fine matrix. ``weights``:
    replicated random weights. ``make_transport(matrix) -> Transport``
    binds the rank's communication context (module docstring)."""
    levels: List[SpmdLevel] = []
    a = a_local
    for _ in range(max_levels - 1):
        n = a.global_num_rows
        if n <= max_coarse:
            break
        w = weights[:n]
        tr = make_transport(a)
        masks = ps.dist_classical_strength(a, theta, tr=tr)
        s = ps.strength_masks_to_par(a, masks)
        tr_s = make_transport(s)
        if coarsen == CoarsenType.CLJP:
            states = ps.dist_split_cljp(s, w, tr=tr_s)
        elif coarsen == CoarsenType.PMIS:
            states = ps.dist_split_pmis(s, w, tr=tr_s)
        elif coarsen in (CoarsenType.Falgout, CoarsenType.RS):
            states = ps.dist_split_falgout(s, w, tr=tr_s)
        else:
            states = ps.dist_split_hmis(s, w, tr=tr_s)
        states = np.asarray(states)

        if interp == InterpType.Direct:
            p_blocks, n_coarse = ps.dist_direct_interpolation(
                a, masks, states, tr=tr, assemble=False)
        elif interp == InterpType.ModClassical:
            p_blocks, n_coarse = ps.dist_mod_classical_interpolation(
                a, s, states, tr=tr, assemble=False)
        else:
            p_blocks, n_coarse = ps.dist_extended_interpolation(
                a, s, states, tr=tr, assemble=False)
            # row-local truncation and row-sum rescale, per rank
            p_blocks = [filter_interp(pb, interp_filter) for pb in p_blocks]

        cb = _coarse_bounds(states, a.partition.row_bounds)
        c_blocks = ps.dist_rap(a, p_blocks, tr=tr, coarse_bounds=cb,
                               assemble=False)
        levels.append(SpmdLevel(a, p_blocks, states))
        a = _coarse_level(a, c_blocks, n_coarse, cb)
    return _finish(levels, a, make_transport)


def spmd_bsr_setup(a_local: ParCSRMatrix, block_size: int,
                   weights: np.ndarray, make_transport,
                   coarsen: CoarsenType = CoarsenType.CLJP,
                   interp: InterpType = InterpType.ModClassical,
                   theta: float = 0.25, max_coarse: int = 50,
                   max_levels: int = 25,
                   strength_type=None) -> SpmdHierarchy:
    """Whole-hierarchy BLOCKED setup per rank: nodal condensation on the
    block-norm graph, nodal CF split, per-component interpolation and the
    blocked Galerkin product, each level through
    ``multilevel.bsr_hierarchy.bsr_extend_distributed``. ``a_local``'s
    partition must be block-aligned (``bsr_hierarchy.block_partition``);
    ``max_coarse`` counts nodes. The coarse levels keep the partition of
    their C-nodes."""
    b = int(block_size)
    levels: List[SpmdLevel] = []
    a = a_local
    for _ in range(max_levels - 1):
        if a.global_num_rows // b <= max_coarse:
            break
        p_blocks, _, states, c_blocks, part_c = bsr_extend_distributed(
            a, b, weights, coarsen, interp, theta, make_transport,
            strength_type=strength_type)
        levels.append(SpmdLevel(a, p_blocks, states))
        a = ParCSRMatrix.from_local_rows(c_blocks, part_c,
                                         first_shard=a.first_shard)
    return _finish(levels, a, make_transport)


def spmd_sa_setup(a_local: ParCSRMatrix, weights: np.ndarray,
                  make_transport, theta: float = 0.0,
                  prolong_weight: float = 4.0 / 3.0,
                  prolong_smooth_steps: int = 1,
                  interp_tol: float = 1e-10,
                  max_coarse: int = 50,
                  max_levels: int = 25) -> SpmdHierarchy:
    """Whole-hierarchy smoothed-aggregation setup per rank: symmetric
    strength -> MIS(2) -> aggregation -> tentative candidates ->
    Jacobi-smoothed P -> Galerkin product, looped; the candidate norms R
    become the next level's candidate. Same transport contract as
    ``spmd_rs_setup``."""
    levels: List[SpmdLevel] = []
    a = a_local
    b_cand = np.ones(a.global_num_rows)
    for _ in range(max_levels - 1):
        n = a.global_num_rows
        if n <= max_coarse:
            break
        w = weights[:n]
        tr = make_transport(a)
        s = ps.strength_masks_to_par(
            a, ps.dist_symmetric_strength(a, theta, tr=tr))
        tr_s = make_transport(s)
        states = np.asarray(ps.dist_mis2(s, w, tr=tr_s))
        # no tie-break weights, as the solver's setup
        n_aggs, aggs = ps.dist_aggregate(a, s, states, tr=tr_s)
        t_blocks, R = ps.dist_fit_candidates(a, n_aggs, aggs, b_cand,
                                             interp_tol, tr=tr,
                                             assemble=False)
        p_blocks = ps.dist_jacobi_prolongation(
            a, t_blocks, prolong_weight, prolong_smooth_steps, tr=tr,
            assemble=False)

        # coarse cols partitioned by root ownership (roots in row order)
        csum = np.concatenate([[0], np.cumsum(states > 0)])
        cb = csum[np.asarray(a.partition.row_bounds)].astype(np.int64)
        c_blocks = ps.dist_rap(a, p_blocks, tr=tr, coarse_bounds=cb,
                               assemble=False)
        levels.append(SpmdLevel(a, p_blocks, states))
        a = _coarse_level(a, c_blocks, n_aggs, cb)
        b_cand = R[:n_aggs]
    return _finish(levels, a, make_transport)
