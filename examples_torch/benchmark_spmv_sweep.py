"""Cache-cleared SpMV sweep, the twin of examples/benchmark_spmv_sweep.py
(the reference's benchmark_spmv.cpp + clear_cache.hpp).

The reference flushes the CPU cache between timed SpMVs so that every
repetition streams from DRAM; the JAX script streams a buffer larger than
a TPU's VMEM. A small operator can stay in the card's L2 across a chain
of products, which overstates the HBM rate, so between repetitions this
sweep reads a buffer of ``FLUSH_BYTES`` (2.6x the H100's 50 MB L2; 8 MB
off the card, the JAX script's value off a TPU) and reports the resident
(chained) and the cleared rate of the 27-point operator for each size on
one shard, with the L2's size and the time one read of the buffer takes
alone: the cleared rate includes it.

Run: python examples_torch/benchmark_spmv_sweep.py [f32|f64] [sizes...] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from examples_torch import _common as C
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                               par_stencil_grid)

FLUSH_BYTES = 128 << 20
HOST_FLUSH_BYTES = 8 << 20
REPS = 20


def chain(dA, x, reps, flush=None):
    """``reps`` normalised products; with ``flush``, the buffer read once
    between them (its sum folded into the result, so it is not skipped)."""
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(reps):
        y = dpar.spmv(dA, x[:, :dA.cols_pad])
        if flush is not None:
            acc = acc + flush.sum() * (1.0 + y[0, 0])
        x = y / (1.0 + y.abs().max())
    return x.sum() + acc


def run_seconds(device, fn):
    """Seconds of the second of two runs of ``fn`` (the JAX script times
    the second call of its compiled chain)."""
    fn()
    return C.seconds(device, fn)[1]


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    dtype = torch.float32 if args[:1] == ["f32"] else torch.float64
    sizes = [int(s) for s in args[1:]] or [32, 48, 64, 96]
    on_card = torch.device(device).type == "cuda"
    flush_bytes = FLUSH_BYTES if on_card else HOST_FLUSH_BYTES
    itemsize = torch.empty((), dtype=dtype).element_size()
    flush = torch.ones((flush_bytes // itemsize,), dtype=dtype,
                       device=device)
    l2 = (torch.cuda.get_device_properties(flush.device).L2_cache_size
          if on_card else None)
    t_flush = run_seconds(device, lambda: [flush.sum() for _ in
                                           range(REPS)]) / REPS
    print(f"flush: {flush_bytes >> 20} MB a repetition, "
          f"{t_flush * 1e6:.1f} us alone"
          + (f"; L2 {l2 / (1 << 20):.0f} MB" if l2 else ""))
    before = C.launches()
    out = {"flush_mb": flush_bytes >> 20, "flush_s": t_flush,
           "l2_bytes": l2, "sizes": {}}
    for n in sizes:
        A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 1)
        dA = dpar.device_put_matrix(A, dtype=dtype,
                                    lane_pad=C.lane_pad(device),
                                    need_transpose=False, device=device)
        x = torch.ones((1, dA.cols_pad), dtype=dtype, device=device)
        t_res = run_seconds(device, lambda: chain(dA, x, REPS)) / REPS
        t_clr = run_seconds(device, lambda: chain(dA, x, REPS,
                                                  flush)) / REPS
        nnz = A.local_nnz
        print(f"{n}^3 ({nnz / 1e6:.1f}M nnz, {dA.on_format}): "
              f"resident {nnz / t_res / 1e9:.1f} Gnnz/s, "
              f"cleared-chain {nnz / t_clr / 1e9:.1f} Gnnz/s "
              f"(incl. {flush_bytes >> 20} MB flush/rep)")
        out["sizes"][n] = {
            "nnz": nnz, "format": dA.on_format,
            "packed_mb": dpar.packed_bytes(dA) / (1 << 20),
            "resident_gnnz_s": nnz / t_res / 1e9,
            "cleared_gnnz_s": nnz / t_clr / 1e9,
            "resident_s": t_res, "cleared_s": t_clr}
        del dA
    return C.finish(out, before)


if __name__ == "__main__":
    main()
