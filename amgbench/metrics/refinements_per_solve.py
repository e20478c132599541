"""Mean refinements of the window's solves by ``solve_mixed`` (the length
of each residual history less one): the solve driver's count. Moves
``solve_ms``."""


def read(ctx):
    if ctx.mix["entry"] != "refine" or not ctx.solves:
        return None
    return sum(steps for steps, _ in ctx.solves) / len(ctx.solves)
