"""Smoothed-aggregation AMG setup (copy of raptor_tpu.aggregation.solver;
aggregation/par_smoothed_aggregation_solver.hpp:14-150).

Each level: symmetric strength -> MIS(2) roots -> aggregates -> tentative
prolongator from the near-nullspace candidates -> Jacobi-smoothed P ->
P^T A P, each stage under its setup phase timer: over the global matrix
(``setup_mode`` "global"), or through the per-shard stages of
``ruge_stuben.par_setup`` over the in-process transport ("distributed"),
on the host whatever the engine knobs say."""

from __future__ import annotations

import time

import numpy as np

from raptor_tpu_torch.aggregation.aggregate import aggregate
from raptor_tpu_torch.aggregation.candidates import fit_candidates
from raptor_tpu_torch.aggregation.mis import mis2
from raptor_tpu_torch.aggregation.prolongation import jacobi_prolongation
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import (
    AggType, ProlongType, RelaxType, StrengthType)
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.multilevel.par_multilevel import (
    ParMultilevel, check_setup_mode)
from raptor_tpu_torch.ruge_stuben import par_setup as ps
from raptor_tpu_torch.ruge_stuben.strength import strength


class ParSmoothedAggregationSolver(ParMultilevel):
    """MIS(2) aggregation with one constant candidate and Jacobi
    prolongation smoothing. ``setup_mode`` "global" (the default) or
    "distributed" (``_extend_hierarchy_distributed``)."""

    def __init__(self, strong_threshold: float = 0.0,
                 agg_type: AggType = AggType.MIS,
                 prolong_type: ProlongType = ProlongType.JacobiProlongation,
                 strength_type: StrengthType = StrengthType.Symmetric,
                 relax_type: RelaxType = RelaxType.SOR,
                 prolong_smooth_steps: int = 1,
                 prolong_weight: float = 4.0 / 3.0):
        super().__init__(strong_threshold, strength_type, relax_type)
        self.agg_type = agg_type
        self.prolong_type = prolong_type
        self.num_candidates = 1
        self.interp_tol = 1e-10
        self.prolong_smooth_steps = prolong_smooth_steps
        self.prolong_weight = prolong_weight
        self.B: np.ndarray = None

    def setup(self, af: ParCSRMatrix) -> None:
        check_setup_mode(self.setup_mode)
        self.B = np.ones(af.global_num_rows)
        self.setup_helper(af)

    def extend_hierarchy(self) -> None:
        if self.setup_mode == "distributed":
            return self._extend_hierarchy_distributed()
        level_ctr = len(self.levels) - 1
        a = self.levels[level_ctr].A
        n = a.global_num_rows
        w = self.weights[:n]

        with self.setup_times.phase("strength"):
            s = strength(a.global_csr, self.strength_type,
                         self.strong_threshold)
        with self.setup_times.phase("aggregation"):
            states = mis2(s, w)
            # the production solver passes no tie-break weights
            # (par_smoothed_aggregation_solver.hpp:80)
            n_aggs, aggs = aggregate(a.global_csr, s, states)
        with self.setup_times.phase("candidates"):
            t, r = fit_candidates(n_aggs, aggs, self.B[:n],
                                  self.num_candidates, self.interp_tol)
        with self.setup_times.phase("prolongation"):
            p = jacobi_prolongation(a.global_csr, t, self.prolong_weight,
                                    self.prolong_smooth_steps)

        pp, _ = self._set_p(a, p, states)
        with self.setup_times.phase("RAP"):
            _, ac = self._galerkin(a, pp, need_ap=False)
        self.levels.append(Level(A=ac))
        self.B = r[:n_aggs * self.num_candidates]

    def _set_p(self, a, p, states):
        """P of the current level, its coarse columns partitioned by root
        ownership (roots in row order); returns (P, coarse bounds)."""
        row_bounds = a.partition.row_bounds
        csum = np.concatenate([[0], np.cumsum(states > 0)])
        col_bounds = csum[row_bounds].astype(np.int64)
        pp = ParCSRMatrix(p, Partition(a.global_num_rows, p.n_cols,
                                       a.partition.n_shards, row_bounds,
                                       col_bounds))
        self.levels[-1].P = pp
        return pp, col_bounds

    def _extend_hierarchy_distributed(self) -> None:
        """The same level extension through the per-shard + transport
        stages (par_mis.cpp, par_aggregate.cpp, par_candidates.cpp,
        par_prolongation.cpp and the Galerkin product of par_matmult.cpp),
        under the global branch's phase names. All on the host:
        ``level_engines`` records "host" with the reason
        "setup_mode=distributed"."""
        level_ctr = len(self.levels) - 1
        a = self.levels[level_ctr].A
        n = a.global_num_rows
        w = self.weights[:n]
        self._record_engine("rap", "host", "setup_mode=distributed")

        with self.setup_times.phase("strength"):
            s_par = ps.strength_masks_to_par(
                a, ps.dist_symmetric_strength(a, self.strong_threshold))
        with self.setup_times.phase("aggregation"):
            states = ps.dist_mis2(s_par, w)
            # no tie-break weights, as in the global branch
            n_aggs, aggs = ps.dist_aggregate(a, s_par, states)
        with self.setup_times.phase("candidates"):
            t, r = ps.dist_fit_candidates(a, n_aggs, aggs, self.B[:n],
                                          self.interp_tol)
        with self.setup_times.phase("prolongation"):
            p = ps.dist_jacobi_prolongation(a, t, self.prolong_weight,
                                            self.prolong_smooth_steps)
        _, col_bounds = self._set_p(a, p, states)
        with self.setup_times.phase("RAP"):
            t0 = time.perf_counter()
            ac = ps.dist_rap(a, p, coarse_bounds=col_bounds)
            self.rap_stats.append(
                (level_ctr, ac.nnz, time.perf_counter() - t0))
        self.levels.append(Level(A=ParCSRMatrix(
            ac.canonicalize(), Partition(p.n_cols, p.n_cols,
                                         a.partition.n_shards, col_bounds,
                                         col_bounds))))
        self.B = r[:n_aggs * self.num_candidates]
