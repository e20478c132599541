"""Smoothed-aggregation AMG benchmark, the twin of
examples/benchmark_sa.py (the reference's profile_tap_sas.cpp /
aggregation examples): SA setup + device V-cycle solve on the 27-point
Laplacian.

Run: python examples_torch/benchmark_sa.py [grid_n] [n_shards] [f32|f64] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.aggregation.solver import ParSmoothedAggregationSolver
from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 48)
    n_shards = C.arg(args, 1, C.N_DEV)
    dtype = (torch.float64 if C.arg(args, 2, "f32", str) == "f64"
             else torch.float32)
    before = C.launches()

    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), n_shards)
    bh = A.mult(np.ones(A.global_num_rows))

    ml = ParSmoothedAggregationSolver(strong_threshold=0.0,
                                      relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.device = device
    if dtype == torch.float32:
        ml.solve_tol = 1e-5
    t0 = time.perf_counter()
    ml.setup(A)
    t_setup = time.perf_counter() - t0
    print(ml.print_hierarchy())

    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=dtype, device=device)
    C.sync(device)
    t_plan = time.perf_counter() - t0

    x0, b = dh.vector(np.zeros_like(bh)), dh.vector(bh)
    dh.solve(x0, b)                            # first solve
    r, t_solve = C.seconds(device, lambda: dh.solve(x0, b))
    iters = int(r.n_iters)

    print(f"SA setup {t_setup:.2f}s, plans {t_plan:.2f}s; "
          f"{iters} V-cycles in {t_solve:.3f}s "
          f"-> {t_solve / max(1, iters) * 1e3:.2f} ms/cycle; "
          f"rel resid {float(r.res[iters]):.3e}")
    return C.finish({"levels": C.levels(ml), "iterations": iters,
                     "residuals": r.res[:iters + 1].tolist()}, before)


if __name__ == "__main__":
    main()
