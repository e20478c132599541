"""AMG setup (copy of raptor_tpu.multilevel.par_multilevel: Ruge-Stuben
with RS/CLJP/Falgout/PMIS/HMIS coarsening, direct, modified-classical or
extended+i interpolation, unknown-based (systems) AMG, the Galerkin
product on the host or on the device, RAP sparsification, and the setup
phase timers).

``ParMultilevel`` (multilevel/par_multilevel.hpp:69-661) holds the knobs
and the levels; ``ParRugeStubenSolver``
(ruge_stuben/par_ruge_stuben_solver.hpp:12-177) extends the hierarchy by
strength -> CF splitting -> interpolation -> P^T A P over the global
matrix; ``aggregation.solver.ParSmoothedAggregationSolver`` extends it by
smoothed aggregation. The interpolation and the Galerkin product each run
on the host or on the device engine (``device.interp``,
``device.spgemm``), as ``interp_mode`` and ``rap_mode`` say: "host",
"device", or "auto", which runs the device engine on levels of at least
``interpolation.DEVICE_MIN_NNZ`` nonzeros when ``device`` is a CUDA card
that is present. ``level_engines`` records, level by level, which engine
ran each and why the host ran in place of a device engine (its width
cap; every other error of a device engine propagates). With
``setup_mode = "distributed"`` the RS, SA and blocked solvers extend the
hierarchy through the per-shard stages of ``ruge_stuben.par_setup`` over
the in-process transport instead, on the host whatever the engine knobs
say (``comm.spmd`` runs the same stages as a whole-hierarchy setup per
rank).
``multilevel.device_hierarchy.DeviceHierarchy`` then packs the levels for
the device solve.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.linalg

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import (
    CFState, CoarsenType, InterpType, RelaxType, StrengthType)
from raptor_tpu_torch.device import spgemm as dsp
from raptor_tpu_torch.linalg.sparsify import injection_matrix, sparsify
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.profiling.timers import Profiler
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf
from raptor_tpu_torch.ruge_stuben import interpolation as interp
from raptor_tpu_torch.ruge_stuben import par_setup as ps
from raptor_tpu_torch.ruge_stuben.interpolation import (
    filter_interp, par_interpolation)
from raptor_tpu_torch.ruge_stuben.strength import strength
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
from raptor_tpu_torch.utils.hostmem import pin_arena

SETUP_MODES = ("global", "distributed")


def check_setup_mode(mode: str) -> None:
    """Raise for a ``setup_mode`` other than "global" or "distributed"."""
    if mode not in SETUP_MODES:
        raise ValueError(f"setup_mode {mode!r}; one of {SETUP_MODES}")


class ParMultilevel:
    """Base hierarchy class. Knob defaults match par_multilevel.hpp:69-94."""

    def __init__(self, strong_threshold: float = 0.0,
                 strength_type: StrengthType = StrengthType.Classical,
                 relax_type: RelaxType = RelaxType.SOR):
        self.strong_threshold = strong_threshold
        self.strength_type = strength_type
        self.relax_type = relax_type
        self.num_smooth_sweeps = 1
        self.relax_weight = 1.0
        self.max_coarse = 50
        self.max_levels = 25
        # "global": each setup stage over the global matrix; "distributed":
        # the per-shard stages (``ruge_stuben.par_setup``)
        self.setup_mode = "global"
        # the first level whose V-cycle exchanges halos through the
        # topology-aware plan (par_multilevel.hpp:88); -1: none
        self.tap_amg = -1
        self.weights: Optional[np.ndarray] = None
        self.solve_tol = 1e-07
        self.max_iterations = 100
        # systems AMG: the number of unknowns a node carries (the RS
        # solver's ``variables`` give each row's)
        self.num_variables = 1
        self.levels: List[Level] = []
        self.coarse_lu = None  # set by duplicate_coarse
        # setup phase timers (the reference's track_times,
        # par_multilevel.hpp:127-205), accumulated over the levels; the
        # split of each level is in ``setup_level_times``
        self.setup_times = Profiler("raptor.setup.")
        self.setup_level_times: List[Dict[str, float]] = []
        # the setup engines: "host", "device" or "auto" (module docstring),
        # and the device a device engine runs on
        self.rap_mode = "auto"
        self.interp_mode = "auto"
        self.device = "cuda"
        # per level: the engine of each setup step ({"interp": ...,
        # "rap": ...}, "host" or "device") and, under "<step>_reason", why
        # the host ran in place of a chosen device engine
        self.level_engines: List[Dict[str, str]] = []
        # the last Galerkin engine, and (level, nnz of AP and Ac, seconds)
        # of each Galerkin product
        self.rap_engine_used = "host"
        self.rap_stats: List[Tuple[int, int, float]] = []

    def _record_engine(self, step: str, engine: str, reason: str = ""):
        rec = self.level_engines[len(self.levels) - 1]
        rec[step] = engine
        if reason:
            rec[f"{step}_reason"] = reason

    def _galerkin(self, a: ParCSRMatrix, p: ParCSRMatrix,
                  need_ap: bool = True
                  ) -> Tuple[Optional[ParCSRMatrix], ParCSRMatrix]:
        """(AP, Ac = P^T A P) through the engine ``rap_mode`` selects: the
        native host SpGEMMs (util/linalg/par_matmult.cpp:79-441), which
        form AP on the way to Ac and return it whatever ``need_ap`` says,
        or ``device.spgemm.rap_device``, which reads AP back only when
        ``need_ap``. Only the device engine's width cap (``CapOverflow``)
        hands the level to the host."""
        if self.rap_mode not in interp.ENGINES:
            raise ValueError(f"rap_mode {self.rap_mode!r}; one of "
                             f"{interp.ENGINES}")
        t0 = time.perf_counter()
        reason = ""
        if self.rap_mode == "device" or (
                self.rap_mode == "auto"
                and interp.auto_uses_device(a.nnz, self.device)):
            try:
                ap_c, ac_c, _ = dsp.rap_device(a.global_csr, p.global_csr,
                                               need_ap=need_ap,
                                               device=self.device)
            except dsp.CapOverflow as e:
                reason = f"cap: {e}"
            else:
                ap = (ParCSRMatrix(ap_c, a.partition.product(p.partition))
                      if need_ap else None)
                ac = ParCSRMatrix(
                    ac_c, p.partition.transpose().product(p.partition))
                return self._galerkin_done("device", "", ap, ac, t0)
        ap = a.multiply(p)
        return self._galerkin_done("host", reason, ap, p.mult_T_mat(ap), t0)

    def _galerkin_done(self, engine, reason, ap, ac, t0):
        self.rap_engine_used = engine
        self._record_engine("rap", engine, reason)
        self.rap_stats.append(
            (len(self.levels) - 1, (0 if ap is None else ap.nnz) + ac.nnz,
             time.perf_counter() - t0))
        return ap, ac

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def setup(self, af: ParCSRMatrix) -> None:
        self.setup_helper(af)

    def setup_helper(self, af: ParCSRMatrix) -> None:
        """par_multilevel.hpp:120-206."""
        # keep the setup's large transient buffers in the persistent heap
        # arena (utils/hostmem.py)
        pin_arena()
        self.levels = [Level(A=af.copy())]
        if self.weights is None:
            # reference: per-rank srand(2448422 + first_local_row); the
            # global equivalent is the single-rank stream
            self.weights = form_rand_weights(af.global_num_rows, 0)
        # each level's phase split: the accumulating timers' growth over
        # its extension
        self.setup_level_times = []
        self.level_engines = []
        self.rap_stats = []
        while (self.levels[-1].A.global_num_rows > self.max_coarse
               and (self.max_levels == -1
                    or len(self.levels) < self.max_levels)):
            before = dict(self.setup_times.times)
            self.level_engines.append({})
            self.extend_hierarchy()
            self.setup_level_times.append({
                k: v - before.get(k, 0.0)
                for k, v in self.setup_times.times.items()
                if v - before.get(k, 0.0) > 0.0})
            # degenerate coarsening (no coarse rows, or no reduction):
            # drop the useless level and stop
            nc = self.levels[-1].A.global_num_rows
            if nc == 0 or nc >= self.levels[-2].A.global_num_rows:
                self.levels.pop()
                self.levels[-1].P = None
                break
        self.duplicate_coarse()

    def extend_hierarchy(self) -> None:
        raise NotImplementedError

    def duplicate_coarse(self) -> None:
        """Dense LU of the coarsest operator (par_multilevel.hpp:223-333):
        scipy's ``(lu, piv)`` with 0-based pivots."""
        ac = self.levels[-1].A.global_csr.to_dense()
        self.coarse_lu = scipy.linalg.lu_factor(ac)

    def print_setup_times(self) -> str:
        """Per-level setup phase splits (print_setup_times,
        par_multilevel.hpp:412-457)."""
        keys = sorted({k for d in self.setup_level_times for k in d})
        lines = ["level  " + "".join(f"{k:>15s}" for k in keys)]
        for i, d in enumerate(self.setup_level_times):
            lines.append(f"{i:5d}  " + "".join(
                f"{d.get(k, 0.0):15.4f}" for k in keys))
        return "\n".join(lines)

    def print_hierarchy(self) -> str:
        """(par_multilevel.hpp:542-565)."""
        lines = ["level     rows      nnz   nnz/row"]
        for i, lvl in enumerate(self.levels):
            n = lvl.A.global_num_rows
            nnz = lvl.A.nnz
            lines.append(f"{i:5d} {n:8d} {nnz:8d} {nnz / max(1, n):9.2f}")
        return "\n".join(lines)


class ParRugeStubenSolver(ParMultilevel):
    """ruge_stuben/par_ruge_stuben_solver.hpp:12-177, with classical or
    symmetric strength: RS (RS below level 3, Falgout from
    there), CLJP, Falgout, PMIS or HMIS coarsening, and direct,
    modified-classical or extended+i interpolation. Extended+i is filtered
    with ``interp_filter`` under every coarsening
    (par_ruge_stuben_solver.hpp:121). ``setup_mode`` "global" (the
    default) runs each stage over the global matrix; "distributed" runs
    the per-shard stages (``_extend_hierarchy_distributed``).

    Systems AMG: with ``num_variables`` > 1 and ``variables`` (each fine
    row's variable id, as ``gallery.fem.par_fem("elasticity", ...)``
    returns them) strength and interpolation keep to same-variable
    couplings, and each coarse level keeps its C-points' ids
    (``Level.variables``). ``sparsify_tol`` > 0 sparsifies each Galerkin
    product (``linalg.sparsify``; ``sparsify_symmetric`` keeps a symmetric
    operator symmetric) in global mode; the distributed mode raises for
    it, where the JAX package ignores it."""

    SPLITS = {CoarsenType.CLJP: cf.split_cljp,
              CoarsenType.Falgout: cf.split_falgout,
              CoarsenType.PMIS: cf.split_pmis,
              CoarsenType.HMIS: cf.split_hmis}
    INTERPOLATIONS = {InterpType.Direct: "direct",
                      InterpType.ModClassical: "mod_classical",
                      InterpType.Extended: "extended"}

    def __init__(self, strong_threshold: float = 0.0,
                 coarsen_type: CoarsenType = CoarsenType.RS,
                 interp_type: InterpType = InterpType.Direct,
                 strength_type: StrengthType = StrengthType.Classical,
                 relax_type: RelaxType = RelaxType.SOR):
        super().__init__(strong_threshold, strength_type, relax_type)
        self.coarsen_type = coarsen_type
        self.interp_type = interp_type
        self.interp_filter = 0.3  # applied to extended+i only
        # systems AMG: the fine rows' variable ids (num_variables > 1)
        self.variables: Optional[np.ndarray] = None
        # RAP sparsification (par_multilevel.hpp:639): 0 turns it off
        self.sparsify_tol = 0.0
        self.sparsify_symmetric = True

    def setup(self, af: ParCSRMatrix) -> None:
        """Raises, before any level is built, for a knob the port does not
        run or a ``variables`` that does not fit ``af``."""
        check_setup_mode(self.setup_mode)
        if self.num_variables != 1 and (
                self.variables is None
                or len(self.variables) != af.global_num_rows):
            raise ValueError(
                f"num_variables = {self.num_variables} needs variables, "
                f"one id for each of the {af.global_num_rows} rows")
        if self.setup_mode == "distributed":
            if self.strength_type != StrengthType.Classical:
                raise NotImplementedError(
                    "setup_mode='distributed' runs classical strength "
                    "only, as the JAX package's does")
            if self.sparsify_tol > 0:
                raise NotImplementedError(
                    "sparsify_tol > 0 with setup_mode='distributed': the "
                    "JAX package's distributed setup ignores the knob; "
                    "sparsify in global mode")
        super().setup(af)

    def _level_variables(self, level_ctr: int) -> Optional[np.ndarray]:
        """The variable ids of a level's rows: ``variables`` on the fine
        level, then what the previous extension kept."""
        lvl = self.levels[level_ctr]
        if level_ctr == 0:
            lvl.variables = self.variables
        return lvl.variables

    def _coarse_variables(self, variables, states):
        """The C-points' variable ids (JAX par_multilevel.py:314-316); with
        one variable the ids pass on unchanged, as there."""
        if self.num_variables > 1:
            return variables[np.asarray(states) == CFState.Selected]
        return variables

    def extend_hierarchy(self) -> None:
        """par_ruge_stuben_solver.hpp:56-177: S -> split -> P -> RAP."""
        if self.setup_mode == "distributed":
            return self._extend_hierarchy_distributed()
        level_ctr = len(self.levels) - 1
        a = self.levels[level_ctr].A
        variables = self._level_variables(level_ctr)
        with self.setup_times.phase("strength"):
            s = strength(a, self.strength_type, self.strong_threshold,
                         self.num_variables, variables)
        w = self.weights[:a.global_num_rows]
        with self.setup_times.phase("cf_splitting"):
            if self.coarsen_type in self.SPLITS:
                states = self.SPLITS[self.coarsen_type](s, w)
            elif level_ctr < 3:
                # RS: split_rs below level 3, then Falgout (:76-86)
                states = cf.split_rs_entry(s)
            else:
                states = cf.split_falgout(s, w)
        kind = self.INTERPOLATIONS[self.interp_type]
        with self.setup_times.phase("interpolation"):
            p = par_interpolation(a, s, states, kind, self.interp_mode,
                                  self.device, self.num_variables,
                                  variables)
            if kind == "direct":
                self._record_engine("interp", "host")
            else:
                self._record_engine("interp", interp.LAST_ENGINE["interp"],
                                    interp.LAST_ENGINE["reason"])
            if kind == "extended":
                p = ParCSRMatrix(filter_interp(p.global_csr,
                                               self.interp_filter),
                                 p.partition)
        self.levels[level_ctr].P = p
        with self.setup_times.phase("RAP"):
            ap, ac = self._galerkin(a, p, need_ap=self.sparsify_tol > 0)
        if self.sparsify_tol > 0:
            # drop small Ac entries outside the minimal pattern into the
            # diagonal (par_sparsify.cpp; arXiv:1512.04629)
            with self.setup_times.phase("sparsify"):
                ac = sparsify(a, p, injection_matrix(np.asarray(states)),
                              ap, ac, self.sparsify_tol,
                              self.sparsify_symmetric)
                ac = ParCSRMatrix(ac.global_csr.canonicalize(),
                                  ac.partition)
        self.levels.append(Level(
            A=ac, variables=self._coarse_variables(variables, states)))

    def _extend_hierarchy_distributed(self) -> None:
        """The same level extension through the per-shard + transport
        stages (``ruge_stuben.par_setup``): classical strength only; RS
        runs the distributed Falgout hybrid (interior RS + boundary CLJP)
        on every level. All on the host: ``level_engines`` records "host"
        with the reason "setup_mode=distributed". Systems AMG reaches the
        strength stage only: the three distributed interpolations take no
        variables, as in the JAX package (JAX par_multilevel.py:355-381),
        so its hierarchy is reproduced bit for bit."""
        level_ctr = len(self.levels) - 1
        a = self.levels[level_ctr].A
        n = a.global_num_rows
        w = self.weights[:n]
        variables = self._level_variables(level_ctr)
        for step in ("interp", "rap"):
            self._record_engine(step, "host", "setup_mode=distributed")

        with self.setup_times.phase("strength"):
            masks = ps.dist_classical_strength(
                a, self.strong_threshold, self.num_variables, variables)
            s = ps.strength_masks_to_par(a, masks)

        ct = self.coarsen_type
        with self.setup_times.phase("cf_splitting"):
            if ct in (CoarsenType.RS, CoarsenType.Falgout):
                # the per-shard analog of split_rs is the Falgout hybrid
                states = ps.dist_split_falgout(s, w)
            elif ct == CoarsenType.CLJP:
                states = ps.dist_split_cljp(s, w)
            elif ct == CoarsenType.PMIS:
                states = ps.dist_split_pmis(s, w)
            elif ct == CoarsenType.HMIS:
                states = ps.dist_split_hmis(s, w)
            else:
                raise ValueError(f"unknown coarsen type {ct}")

        it = self.interp_type
        with self.setup_times.phase("interpolation"):
            if it == InterpType.Direct:
                pg = ps.dist_direct_interpolation(a, masks, states)
            elif it == InterpType.ModClassical:
                pg = ps.dist_mod_classical_interpolation(a, s, states)
            elif it == InterpType.Extended:
                pg = filter_interp(
                    ps.dist_extended_interpolation(a, s, states),
                    self.interp_filter)
            else:
                raise ValueError(f"unknown interp type {it}")

        # P inherits A's row partition; coarse cols owned where their
        # C-points live (par_interpolation.cpp partition rule)
        row_bounds = a.partition.row_bounds
        sel = np.asarray(states) == CFState.Selected
        csum = np.concatenate([[0], np.cumsum(sel)])
        col_bounds = csum[row_bounds].astype(np.int64)
        part_p = Partition(a.global_num_rows, pg.n_cols,
                           a.partition.n_shards, row_bounds, col_bounds)
        self.levels[level_ctr].P = ParCSRMatrix(pg, part_p)

        with self.setup_times.phase("RAP"):
            t0 = time.perf_counter()
            ac = ps.dist_rap(a, pg, coarse_bounds=col_bounds)
            self.rap_stats.append(
                (level_ctr, ac.nnz, time.perf_counter() - t0))
        part_c = Partition(pg.n_cols, pg.n_cols, a.partition.n_shards,
                           col_bounds, col_bounds)
        self.levels.append(Level(
            A=ParCSRMatrix(ac.canonicalize(), part_c),
            variables=self._coarse_variables(variables, states)))
