"""Host ms a solve spends on its vectors' copies: the program's
``raptor.put`` spans (b and x0 padded and copied to the card) and its
``raptor.host`` span (x copied back), over two solves recorded after the
window, over the solves (``program_trace.probe``). The solve driver's
layer. Moves ``solve_ms``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.read(ctx, "solve_io_ms")
