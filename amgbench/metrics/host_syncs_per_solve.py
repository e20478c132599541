"""Blocking card-to-host reads a solve makes: the program's counter
``syncs`` over ``solves`` (``raptor_tpu_torch.profiling.timers``), every
``float`` of a norm and the read back of the solution, in two solves
recorded after the window (``program_trace.probe``). The solve driver's
layer (``DeviceHierarchy.solve_mixed``). Moves ``solve_ms``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.read(ctx, "host_syncs_per_solve")
