"""Smoothed-aggregation setup sweep, the twin of
examples/benchmark_setup_sweeps.py: prolongation smoothing steps 0-3,
plain against topology-aware exchange (the reference's
examples/benchmark_setup_sweeps.cpp).

For each ``prolong_smooth_steps`` the script builds the SA hierarchy,
reports setup time + hierarchy shape + operator complexity, then runs the
float64 device solve to 1e-7 twice: with the flat halo exchange and with
the TAP schedule on the (hosts x local) layout of the stacked shards, and
prints solve time and iteration count for both. Where the JAX script
solves once to compile before the timed solve, the twin runs one V-cycle.

Run: python examples_torch/benchmark_setup_sweeps.py [grid_n] [hosts] [local] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.aggregation.solver import ParSmoothedAggregationSolver
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 64)
    H = C.arg(args, 1, 2)
    L = C.arg(args, 2, 4)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         H * L)
    rng = np.random.default_rng(1)
    xr = rng.random(A.global_num_rows)
    b = A.mult(xr)

    mesh2 = dpar.make_mesh2(H, L)
    sweeps = []
    for steps in range(4):
        print(f"\n== prolongation sweeps: {steps} ==")
        ml = ParSmoothedAggregationSolver(0.0,
                                          prolong_smooth_steps=steps)
        ml.solve_tol = 1e-7
        ml.max_iterations = 1000
        ml.device = device
        t0 = time.perf_counter()
        ml.setup(A)
        complexity = sum(lvl.A.nnz for lvl in ml.levels) / A.nnz
        print(f"setup {time.perf_counter() - t0:.2f} s, "
              f"{len(ml.levels)} levels, op complexity "
              f"{complexity:.2f}")
        row = {"steps": steps, "levels": C.levels(ml),
               "op_complexity": complexity}

        for tap, label in ((-1, "flat"), (0, "TAP")):
            ml.tap_amg = tap
            dh = DeviceHierarchy(ml, device=device, mesh=mesh2)
            x0 = dh.vector(np.zeros_like(b))
            bd = dh.vector(b)
            C.warm_up(dh, x0, bd)      # the JAX script's compile
            res, dt = C.seconds(device, lambda: dh.solve(x0, bd))
            print(f"  {label:5s}: {int(res.n_iters):3d} iters, "
                  f"{dt:.3f} s warm")
            row[label] = int(res.n_iters)
            row[f"{label}_residuals"] = res.res[:res.n_iters + 1].tolist()
        sweeps.append(row)
    return C.finish({"sweeps": sweeps}, before)


if __name__ == "__main__":
    main()
