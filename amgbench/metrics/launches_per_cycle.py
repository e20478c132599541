"""Kernel launches of one V-cycle: the CUDA launch calls
(``cudaLaunchKernel*``, ``cuLaunchKernel*``) whose host start lies inside
a level-0 ``raptor.vcycle.L0`` span, over those spans, in two solves under
``torch.profiler`` after the window (``program_trace.probe``). The
cycle's layer. Moves ``solve_ms``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.read(ctx, "launches_per_cycle")
