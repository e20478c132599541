"""Timed plain against topology-aware SpMV / SpMV^T on a (host, local)
layout, the twin of examples/benchmark_tap_spmv.py (the reference's
examples/benchmark_tap_spmv.cpp + profile_tap_steps.cpp, which time
ParMatrix::mult against tap_mult over live MPI,
util/linalg/par_spmv.cpp:25-89).

Both paths run the same on / off split SpMV over the stacked shards;
only the halo exchange differs: the flat exchange against the 4-step
TAP schedule (local_L / local_S / global / local_R) that keeps fan-out
within a host. Each is timed as a chain of normalised products (CUDA
events behind a synchronize on the card). Alongside the times the static
comm model prints the inter-host byte counts each schedule moves.

Run: python examples_torch/benchmark_tap_spmv.py [grid_n] [hosts] [local] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.comm.plan import build_comm_plan
from raptor_tpu_torch.comm.tap import build_tap_plan, device_put_tap
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.tap_ops import tap_spmv, tap_spmv_T
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.profiling.comm_model import (model_comm_plan,
                                                   model_tap_plan)


def make_chain(op):
    """k normalised applications of ``op(A, T, x)``; the sum of the last
    (normalised by the max over every shard, as the JAX chain's pmax)."""
    def chain(A, T, x, k):
        for _ in range(k):
            b = op(A, T, x)
            x = b / b.abs().max()
        return x.sum()
    return chain


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 512)
    H = C.arg(args, 1, 2)
    L = C.arg(args, 2, 4)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         H * L)
    dA = dpar.device_put_matrix(A, dtype=torch.float32, lane_pad=128,
                                device=device)
    T = device_put_tap(build_tap_plan(A, H, L), torch.float32,
                       dpar.resolve_device(device))
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(A.global_num_cols),
        A.partition.col_bounds, dA.cols_pad, dtype=torch.float32,
        device=device)

    # equality of the two paths before timing them
    b_plain = dpar.spmv(dA, x)
    b_tap = tap_spmv(dA, T, x)
    err = float((b_plain - b_tap).abs().max())
    C.check(err < 1e-4 * float(b_plain.abs().max()),
            f"TAP SpMV {err} from the plain one")

    d = dict(n_lo=2, n_hi=202)
    per_plain = C.delta_time(device, make_chain(
        lambda A, T, v: dpar.spmv(A, v)), dA, T, x, **d)
    per_plain_T = C.delta_time(device, make_chain(
        lambda A, T, v: dpar.spmv_T(A, v)), dA, T, x, **d)
    per_tap = C.delta_time(device, make_chain(tap_spmv), dA, T, x, **d)
    per_tap_T = C.delta_time(device, make_chain(tap_spmv_T), dA, T, x, **d)

    gn = A.nnz / 1e9
    print(f"{H}x{L} mesh, {n}x{n} aniso, nnz={A.nnz} ({dA.on_format})")
    print(f"plain SpMV   {per_plain * 1e6:9.1f} us  "
          f"{gn / per_plain:7.2f} Gnnz/s")
    print(f"TAP   SpMV   {per_tap * 1e6:9.1f} us  "
          f"{gn / per_tap:7.2f} Gnnz/s")
    print(f"plain SpMV^T {per_plain_T * 1e6:9.1f} us  "
          f"{gn / per_plain_T:7.2f} Gnnz/s")
    print(f"TAP   SpMV^T {per_tap_T * 1e6:9.1f} us  "
          f"{gn / per_tap_T:7.2f} Gnnz/s")

    plain_stats = model_comm_plan(build_comm_plan(A), shards_per_host=L)
    tap_stats = model_tap_plan(build_tap_plan(A, H, L))
    saved = plain_stats.inter_host_bytes - tap_stats.inter_host_bytes
    print(f"DCN bytes/exchange: plain {plain_stats.inter_host_bytes} vs "
          f"TAP {tap_stats.inter_host_bytes} "
          f"({100.0 * saved / max(1, plain_stats.inter_host_bytes):.1f}% "
          f"saved)")
    return C.finish({"nnz": A.nnz, "format": dA.on_format,
                     "tap_max_abs_diff": err,
                     "plain_inter_host_bytes": plain_stats.inter_host_bytes,
                     "tap_inter_host_bytes": tap_stats.inter_host_bytes,
                     "us": {"plain": per_plain * 1e6, "tap": per_tap * 1e6,
                            "plain_T": per_plain_T * 1e6,
                            "tap_T": per_tap_T * 1e6}}, before)


if __name__ == "__main__":
    main()
