"""Ruge-Stuben AMG: the port's ``ParRugeStubenSolver`` with a
configuration's ``setup`` knobs (``strong_threshold``, ``coarsen_type``,
``interp_type`` and ``relax_type`` by their enum names,
``num_smooth_sweeps``, ``max_levels``, ``rap_mode``, ``interp_mode``)."""

from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def build(setup: dict, device) -> ParRugeStubenSolver:
    ml = ParRugeStubenSolver(setup["strong_threshold"],
                             CoarsenType[setup["coarsen_type"]],
                             InterpType[setup["interp_type"]],
                             relax_type=RelaxType[setup["relax_type"]])
    ml.num_smooth_sweeps = setup["num_smooth_sweeps"]
    ml.max_levels = setup["max_levels"]
    ml.rap_mode = setup["rap_mode"]
    ml.interp_mode = setup["interp_mode"]
    ml.device = str(device)
    return ml
