"""Host ms of one V-cycle inside a real solve: the mean of the
program's level-0 ``raptor.vcycle.L0`` spans in two solves recorded
after the window (``program_trace.probe``), each a refinement's whole
cycle as the solve enqueues it. The cycle's layer
(``DeviceHierarchy.vcycle``). Moves ``solve_ms``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.read(ctx, "cycle_host_ms")
