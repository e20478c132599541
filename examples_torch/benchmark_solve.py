"""Setup + solve wall-time benchmark over the reference's system
selector, the twin of examples/benchmark_solve.py (the reference's
examples/benchmark_solve.cpp: system 0 = 3-D 27-point Laplacian, 1 = 2-D
rotated anisotropic diffusion, 3 = a MatrixMarket file; RS + Direct +
Classical + SOR, theta = 0.25, b = A @ rand(x), float64).

The reference clears the L2 cache between phases and reports
raptor_setup / raptor_solve seconds; here each phase is timed the same
way (the device plans are rebuilt per run, which is the cold path). The
shards are the 8 of the JAX package's device mesh, stacked on one
device. System 3 reads the file given as the second argument.

Run: python examples_torch/benchmark_solve.py [system] [n|file] [eps] [theta] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.gallery.io import read_par_mm
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               laplace_stencil_27pt,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    system = C.arg(args, 0, 0)
    n_shards = C.N_DEV
    before = C.launches()

    if system == 0:
        n = C.arg(args, 1, 50)
        A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), n_shards)
    elif system == 1:
        n = C.arg(args, 1, 512)
        eps = C.arg(args, 2, 0.1, float)
        theta = C.arg(args, 3, np.pi / 4, float)
        A = par_stencil_grid(diffusion_stencil_2d(eps, theta), (n, n),
                             n_shards)
    else:
        if len(args) < 2:
            raise SystemExit("system 3 reads a MatrixMarket file: give its "
                             "path as the second argument")
        A = read_par_mm(args[1], n_shards)

    # b = A x_rand (benchmark_solve.cpp: x.set_rand_values(); A->mult)
    rng = np.random.default_rng(0)
    x_true = rng.random(A.global_num_cols)
    b = A.mult(x_true)

    t0 = time.perf_counter()
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.Direct,
                             relax_type=RelaxType.SOR)
    ml.device = device
    ml.setup(A)
    raptor_setup = time.perf_counter() - t0
    print(ml.print_hierarchy())

    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, device=device)
    C.sync(device)
    plans = time.perf_counter() - t0

    x0 = dh.vector(np.zeros_like(b))
    bd = dh.vector(b)
    dh.solve(x0, bd)              # first solve
    r, raptor_solve = C.seconds(device, lambda: dh.solve(x0, bd))
    iters = int(r.n_iters)

    print(f"raptor_setup {raptor_setup:.4f}s  (device plans +{plans:.4f}s)")
    print(f"raptor_solve {raptor_solve:.4f}s  ({iters} V-cycles, rel resid "
          f"{float(r.res[iters]):.3e})")
    return C.finish({"levels": C.levels(ml), "iterations": iters,
                     "residuals": r.res[:iters + 1].tolist()}, before)


if __name__ == "__main__":
    main()
