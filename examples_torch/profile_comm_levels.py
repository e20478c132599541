"""Per-level communication profile of an AMG hierarchy, the twin of
examples/profile_comm_levels.py (the reference's
examples/benchmark_matops.cpp + profile_amg.cpp).

The reference walks every hierarchy level and times the halo exchange
under different MPI protocols (benchmark_matops.cpp:400-469). Here the
per-level figures are the static comm model's message counts / bytes by
protocol class and locality, plus each level's float64 SpMV (with its
halo exchange over the stacked shards) on the device, 20 calls timed by
CUDA events behind a synchronize on the card.

Run: python examples_torch/profile_comm_levels.py [grid_n] [n_shards] [hosts] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.comm.plan import build_comm_plan
from raptor_tpu_torch.core.types import CoarsenType, InterpType
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver
from raptor_tpu_torch.profiling.comm_model import model_comm_plan


def time_op(device, fn, reps=20):
    """Seconds of one call: one call to warm up, then ``reps`` back to
    back, over ``reps``."""
    fn()
    def run():
        for _ in range(reps):
            fn()
    return C.seconds(device, run)[1] / reps


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 256)
    n_shards = C.arg(args, 1, C.N_DEV)
    hosts = C.arg(args, 2, 2)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         n_shards)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical)
    ml.device = device
    ml.setup(A)

    print(f"{'lvl':>3} {'rows':>9} {'nnz':>10} {'msgs':>5} {'interB':>10} "
          f"{'bytes':>10} {'spmv_ms':>8}")
    rows = []
    for i, lvl in enumerate(ml.levels):
        Al = lvl.A
        stats = model_comm_plan(build_comm_plan(Al),
                                shards_per_host=max(1, n_shards // hosts))
        dA = dpar.device_put_matrix(Al, dtype=torch.float64,
                                    lane_pad=C.lane_pad(device),
                                    device=device)
        x = dpar.device_put_vector(
            np.random.default_rng(i).random(Al.global_num_cols),
            Al.partition.col_bounds, dA.cols_pad, device=device)
        dt = time_op(device, lambda dA=dA, x=x: dpar.spmv(dA, x))
        msgs = sum(stats.n_msgs.values())
        bts = sum(stats.n_bytes.values())
        print(f"{i:>3} {Al.global_num_rows:>9} {Al.nnz:>10} "
              f"{msgs:>5} {stats.inter_host_bytes:>10} "
              f"{bts:>10} {dt * 1e3:>8.3f}")
        rows.append((Al.global_num_rows, Al.nnz, msgs,
                     stats.inter_host_bytes, bts))
    return C.finish({"levels": rows}, before)


if __name__ == "__main__":
    main()
