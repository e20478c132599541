"""Host AMG setup (copy of raptor_tpu.multilevel.par_multilevel:
Ruge-Stuben with RS/PMIS/HMIS coarsening, modified-classical or extended+i
interpolation, and the host Galerkin product).

``ParMultilevel`` (multilevel/par_multilevel.hpp:69-661) holds the knobs
and the levels; ``ParRugeStubenSolver``
(ruge_stuben/par_ruge_stuben_solver.hpp:12-177) extends the hierarchy by
strength -> CF splitting -> interpolation -> P^T A P, all on the host over
the global matrix. ``multilevel.device_hierarchy.DeviceHierarchy`` then
packs the levels for the device solve.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.linalg

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import (
    CoarsenType, InterpType, RelaxType, StrengthType)
from raptor_tpu_torch.multilevel.level import Level
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf
from raptor_tpu_torch.ruge_stuben.interpolation import (
    filter_interp, par_interpolation)
from raptor_tpu_torch.ruge_stuben.strength import strength
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights


class ParMultilevel:
    """Base hierarchy class. Knob defaults match par_multilevel.hpp:69-94."""

    def __init__(self, strong_threshold: float = 0.0,
                 relax_type: RelaxType = RelaxType.SOR):
        self.strong_threshold = strong_threshold
        self.relax_type = relax_type
        self.num_smooth_sweeps = 1
        self.max_coarse = 50
        self.max_levels = 25
        self.weights: Optional[np.ndarray] = None
        self.solve_tol = 1e-07
        self.max_iterations = 100
        self.levels: List[Level] = []
        self.coarse_lu = None  # set by duplicate_coarse

    def _galerkin(self, a: ParCSRMatrix,
                  p: ParCSRMatrix) -> Tuple[ParCSRMatrix, ParCSRMatrix]:
        """(AP, Ac = P^T A P) through the native host SpGEMMs
        (util/linalg/par_matmult.cpp:79-441)."""
        ap = a.multiply(p)
        return ap, p.mult_T_mat(ap)

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def setup(self, af: ParCSRMatrix) -> None:
        """par_multilevel.hpp:120-206."""
        self.levels = [Level(A=af.copy())]
        if self.weights is None:
            # reference: per-rank srand(2448422 + first_local_row); the
            # global equivalent is the single-rank stream
            self.weights = form_rand_weights(af.global_num_rows, 0)
        while (self.levels[-1].A.global_num_rows > self.max_coarse
               and (self.max_levels == -1
                    or len(self.levels) < self.max_levels)):
            self.extend_hierarchy()
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

    def print_hierarchy(self) -> str:
        """(par_multilevel.hpp:542-565)."""
        lines = ["level     rows      nnz   nnz/row"]
        for i, lvl in enumerate(self.levels):
            n = lvl.A.global_num_rows
            nnz = lvl.A.nnz
            lines.append(f"{i:5d} {n:8d} {nnz:8d} {nnz / max(1, n):9.2f}")
        return "\n".join(lines)


class ParRugeStubenSolver(ParMultilevel):
    """ruge_stuben/par_ruge_stuben_solver.hpp:12-177, single-variable with
    classical strength: RS (RS below level 3, Falgout from there), PMIS or
    HMIS coarsening, and modified-classical or extended+i interpolation.
    Extended+i is filtered with ``interp_filter`` under every coarsening
    (par_ruge_stuben_solver.hpp:121). CLJP and Falgout as the coarsening,
    direct interpolation and symmetric strength belong to a later slice of
    the port."""

    COARSENINGS = (CoarsenType.RS, CoarsenType.PMIS, CoarsenType.HMIS)
    INTERPOLATIONS = {InterpType.ModClassical: "mod_classical",
                      InterpType.Extended: "extended"}

    def __init__(self, strong_threshold: float = 0.0,
                 coarsen_type: CoarsenType = CoarsenType.RS,
                 interp_type: InterpType = InterpType.ModClassical,
                 strength_type: StrengthType = StrengthType.Classical,
                 relax_type: RelaxType = RelaxType.SOR):
        if coarsen_type not in self.COARSENINGS:
            raise NotImplementedError(
                f"{coarsen_type}: the port runs RS, PMIS and HMIS "
                f"coarsening; CLJP and Falgout come with a later slice")
        if interp_type not in self.INTERPOLATIONS:
            raise NotImplementedError(
                f"{interp_type}: the port runs modified-classical and "
                f"extended+i interpolation; direct comes with a later slice")
        if strength_type != StrengthType.Classical:
            raise NotImplementedError(
                f"{strength_type}: the port runs classical strength")
        super().__init__(strong_threshold, relax_type)
        self.coarsen_type = coarsen_type
        self.interp_type = interp_type
        self.interp_filter = 0.3  # applied to extended+i only

    def extend_hierarchy(self) -> None:
        """par_ruge_stuben_solver.hpp:56-177: S -> split -> P -> RAP."""
        level_ctr = len(self.levels) - 1
        a = self.levels[level_ctr].A
        s = strength(a, self.strong_threshold)
        w = self.weights[:a.global_num_rows]
        if self.coarsen_type == CoarsenType.PMIS:
            states = cf.split_pmis(s, w)
        elif self.coarsen_type == CoarsenType.HMIS:
            states = cf.split_hmis(s, w)
        elif level_ctr < 3:
            # RS: split_rs below level 3, then Falgout (:76-86)
            states = cf.split_rs_entry(s)
        else:
            states = cf.split_falgout(s, w)
        kind = self.INTERPOLATIONS[self.interp_type]
        p = par_interpolation(a, s, states, kind)
        if kind == "extended":
            p = ParCSRMatrix(filter_interp(p.global_csr, self.interp_filter),
                             p.partition)
        self.levels[level_ctr].P = p
        _, ac = self._galerkin(a, p)
        self.levels.append(Level(A=ac))
