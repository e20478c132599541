"""The fine operator's SpMV against its HBM roofline, in %: the least
bytes y = A0 x needs (each nonzero's value, x and y, in the hierarchy's
element size, nonzeros counted from the benchmark's own CSR) at the HBM
peak, over the device time of one ``device.par.spmv`` of the packed A0,
back to back behind a spin kernel. The kernels' layer (``device/
kernels.py``, ``csrc/*.cu``). Moves ``solve_ms``."""

from amgbench import timing


def read(ctx):
    ms = ctx.a0_spmv_ms
    if ms is None:
        return None
    rows, cols = ctx.matrix.shape
    nbytes = timing.spmv_bytes(ctx.matrix.nnz, rows, cols,
                               ctx.entry.dh.levels[0].A.dtype.itemsize)
    return timing.roofline_percent(nbytes, ms / 1e3)
