"""Device ms of one V-cycle of the hierarchy in the cell's precision
(``DeviceHierarchy.vcycle``, ``device/relax.py``, ``device/par.py:spmv``):
CUDA events around a chain of at least 20 cycles on a fixed residual,
divided by the count. Moves ``solve_ms``."""


def read(ctx):
    chain = ctx.vcycle_chain
    return None if chain is None else chain["device_ms"]
