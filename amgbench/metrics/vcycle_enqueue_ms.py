"""Host ms to enqueue one V-cycle: the host clock over the same chain as
``vcycle_ms``, stopped before its synchronize, divided by the count. Where
it matches ``vcycle_ms`` the host's launches set the cycle's pace. Moves
``solve_ms``."""


def read(ctx):
    chain = ctx.vcycle_chain
    return None if chain is None else chain["enqueue_ms"]
