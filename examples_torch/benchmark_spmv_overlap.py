"""Overlap of the halo exchange with the on-shard product, the twin of
examples/benchmark_spmv_overlap.py (the reference's
benchmark_spmv_overlap.cpp + benchmark_tap_spmv.cpp).

The reference overlaps the MPI halo exchange with the on-process product
by hand (Isend / Irecv, local product, Waitall); the JAX package leaves
it to XLA's scheduler, and its script times that against an order forced
serial. Here ``device.par.spmv_overlap`` runs the exchange on a side
stream against the on-block product ("overlapped"), and ``spmv`` enqueues
both on one stream ("serialized"). Each is timed per product by the delta
of two chains (CUDA events behind a synchronize on the card) on the
float32 27-point operator over the stacked shards; the twin raises unless
the two products are bit-equal.

Run: python examples_torch/benchmark_spmv_overlap.py [grid_n] [n_shards] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                               par_stencil_grid)


def chain(op, dA, x, k):
    """k products of the same x, their sums added (the JAX script's
    loop)."""
    c = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(k):
        c = c + op(dA, x).sum()
    return c


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 64)
    n_dev = C.arg(args, 1, C.N_DEV)
    before = C.launches()
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), n_dev)
    dA = dpar.device_put_matrix(A, dtype=torch.float32, lane_pad=128,
                                device=device)
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(A.global_num_cols),
        A.partition.col_bounds, dA.cols_pad, dtype=torch.float32,
        device=device)

    same = torch.equal(dpar.spmv_overlap(dA, x), dpar.spmv(dA, x))
    C.check(same, "spmv_overlap is not bit-equal to spmv")
    t_over = C.delta_time(device, chain, dpar.spmv_overlap, dA, x,
                          n_lo=2, n_hi=102)
    t_serial = C.delta_time(device, chain, dpar.spmv, dA, x,
                            n_lo=2, n_hi=102)
    gain = 100.0 * (t_serial - t_over) / max(t_serial, 1e-12)
    print(f"overlapped : {t_over * 1e6:9.1f} us/SpMV "
          f"({A.nnz / t_over / 1e9:.2f} Gnnz/s)")
    print(f"serialized : {t_serial * 1e6:9.1f} us/SpMV "
          f"({A.nnz / t_serial / 1e9:.2f} Gnnz/s)")
    print(f"overlap gain: {gain:.1f}%")
    return C.finish({"nnz": A.nnz, "format": dA.on_format,
                     "bit_equal": same, "overlapped_s": t_over,
                     "serialized_s": t_serial, "gain_pct": gain}, before)


if __name__ == "__main__":
    main()
