"""Host ms a solve spends blocked on the card: the program's
``raptor.sync`` spans (each blocking ``float`` of a norm) summed over two
solves recorded after the window, over the solves
(``program_trace.probe``). The solve driver's layer. Moves
``solve_ms``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.read(ctx, "solve_wait_ms")
