"""The card's idle share over two whole solves of the entry, in %: one
less the union of its activity over the traced span (``trace.py``). Moves
``solve_ms``."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
