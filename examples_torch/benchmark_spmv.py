"""SpMV benchmark, plain against TAP exchange, the twin of
examples/benchmark_spmv.py (the reference's benchmark_spmv.cpp,
benchmark_tap_spmv.cpp): the float32 SpMV of the 27-point Laplacian over
the 8 stacked shards, timed as a chain of normalised products (CUDA
events behind a synchronize on the card), and the static comm model.

Run: python examples_torch/benchmark_spmv.py [grid_n] [iters] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.comm.plan import build_comm_plan
from raptor_tpu_torch.comm.tap import build_tap_plan
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                               par_stencil_grid)
from raptor_tpu_torch.profiling.comm_model import model_comm_plan


def chain(dA, x, k):
    """k normalised SpMVs, x <- A x / max |A x|; the sum of the last."""
    for _ in range(k):
        b = dpar.spmv(dA, x)
        x = b / b.abs().max()
    return x.sum()


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 64)
    n_dev = C.N_DEV
    before = C.launches()
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), n_dev)
    dA = dpar.device_put_matrix(A, dtype=torch.float32, lane_pad=128,
                                device=device)
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(A.global_num_cols),
        A.partition.col_bounds, dA.cols_pad, dtype=torch.float32,
        device=device)

    per = C.delta_time(device, chain, dA, x)
    print(f"plain SpMV ({dA.on_format}): {per * 1e6:.1f} us "
          f"= {A.nnz / per / 1e9:.2f} Gnnz/s on {n_dev} device(s)")

    # static comm statistics
    stats = model_comm_plan(build_comm_plan(A), shards_per_host=max(
        1, n_dev // 2))
    print(stats)
    out = {"nnz": A.nnz, "format": dA.on_format,
           "n_msgs": dict(stats.n_msgs), "n_bytes": dict(stats.n_bytes),
           "inter_host_bytes": stats.inter_host_bytes}
    if n_dev >= 2:
        tap = build_tap_plan(A, 2, n_dev // 2)
        print(f"TAP dedup: {tap.dcn_values} vs plain "
              f"{tap.dcn_values_plain} inter-host values")
        out.update(dcn_values=int(tap.dcn_values),
                   dcn_values_plain=int(tap.dcn_values_plain))
    return C.finish(out, before)


if __name__ == "__main__":
    main()
