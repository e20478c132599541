"""Configuration of the solvers (copy of raptor_tpu.utils.config).

The reference exposes its knobs as constructor arguments and public members
(par_multilevel.hpp:628-660); here the whole knob set is one dataclass that
``to_dict`` / ``from_dict`` carry as plain data (enums by name, so that a
dict written by the JAX package's ``AMGConfig.to_dict`` builds the same
solver here) and ``build`` turns into the port's solver.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from raptor_tpu_torch.core.types import (
    AggType, CoarsenType, InterpType, ProlongType, RelaxType, StrengthType)

_ENUMS = {"strength_type": StrengthType, "coarsen_type": CoarsenType,
          "interp_type": InterpType, "agg_type": AggType,
          "prolong_type": ProlongType, "relax_type": RelaxType}


@dataclasses.dataclass
class AMGConfig:
    # method selection
    method: str = "ruge_stuben"            # "ruge_stuben" | "smoothed_agg"
    # strength / coarsening / interpolation
    strong_threshold: float = 0.0
    strength_type: StrengthType = StrengthType.Classical
    coarsen_type: CoarsenType = CoarsenType.RS
    interp_type: InterpType = InterpType.Direct
    interp_filter: float = 0.3
    # aggregation (SA)
    agg_type: AggType = AggType.MIS
    prolong_type: ProlongType = ProlongType.JacobiProlongation
    prolong_smooth_steps: int = 1
    prolong_weight: float = 4.0 / 3.0
    # smoothing
    relax_type: RelaxType = RelaxType.SOR
    num_smooth_sweeps: int = 1
    relax_weight: float = 1.0
    # hierarchy limits (par_multilevel.hpp:83-94)
    max_coarse: int = 50
    max_levels: int = 25
    sparsify_tol: float = 0.0
    # solve
    solve_tol: float = 1e-07
    max_iterations: int = 100
    # topology (the first level of node-aware exchange; -1 = off)
    tap_amg: int = -1
    # setup engines: "host" (native kernels), "device" (the card:
    # device/spgemm.py + device/interp.py), "auto" (the device's for large
    # levels on the card)
    rap_mode: str = "auto"
    interp_mode: str = "auto"
    # setup distribution: "global" or "distributed" (per-shard stages over
    # the transport)
    setup_mode: str = "global"
    # device
    dtype: str = "float64"
    lane_pad: int = 1

    def build(self, weights: Optional[np.ndarray] = None):
        """The configured solver, ready for ``setup``. As in the JAX
        package, ``sparsify_tol``, ``dtype`` and ``lane_pad`` are carried
        but not applied: the caller sets them on the solver and on its
        device hierarchy."""
        if self.method == "ruge_stuben":
            from raptor_tpu_torch.multilevel.par_multilevel import (
                ParRugeStubenSolver)
            ml = ParRugeStubenSolver(
                self.strong_threshold, self.coarsen_type, self.interp_type,
                self.strength_type, self.relax_type)
            ml.interp_filter = self.interp_filter
        elif self.method == "smoothed_agg":
            from raptor_tpu_torch.aggregation.solver import (
                ParSmoothedAggregationSolver)
            st = (self.strength_type
                  if self.strength_type != StrengthType.Classical
                  else StrengthType.Symmetric)
            ml = ParSmoothedAggregationSolver(
                self.strong_threshold, self.agg_type, self.prolong_type,
                st, self.relax_type, self.prolong_smooth_steps,
                self.prolong_weight)
        else:
            raise ValueError(f"unknown method {self.method}")
        ml.num_smooth_sweeps = self.num_smooth_sweeps
        ml.relax_weight = self.relax_weight
        ml.max_coarse = self.max_coarse
        ml.max_levels = self.max_levels
        ml.solve_tol = self.solve_tol
        ml.max_iterations = self.max_iterations
        ml.tap_amg = self.tap_amg
        ml.rap_mode = self.rap_mode
        ml.interp_mode = self.interp_mode
        ml.setup_mode = self.setup_mode
        if weights is not None:
            ml.weights = np.asarray(weights, dtype=np.float64)
        return ml

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for k, v in d.items():
            if k in _ENUMS:
                d[k] = v.name
        return d

    @staticmethod
    def from_dict(d: dict) -> "AMGConfig":
        kw = dict(d)
        for k, enum_cls in _ENUMS.items():
            if k in kw and isinstance(kw[k], str):
                kw[k] = enum_cls[kw[k]]
        return AMGConfig(**kw)
