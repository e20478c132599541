"""AMG setup + solve benchmark, the twin of examples/benchmark_amg.py
(the reference's examples/benchmark_setup.cpp, benchmark_solve.cpp,
benchmark_amg.cpp).

The JAX script's "solve compile+first" phase is the first solve here
(the eager port compiles nothing; the first call loads the kernels).

Run: python examples_torch/benchmark_amg.py [grid_n] [n_shards] [f32|f64] [relax] [sweeps] [--device cpu]
"""

import contextlib
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver
from raptor_tpu_torch.profiling.timers import Profiler


@contextlib.contextmanager
def phase(prof, name, device):
    """``prof.phase(name)`` that ends after the card's queued work."""
    with prof.phase(name):
        yield
        C.sync(device)


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 100)
    n_shards = C.arg(args, 1, C.N_DEV)
    dtype = (torch.float32 if C.arg(args, 2, "f64", str) == "f32"
             else torch.float64)
    before = C.launches()

    prof = Profiler()
    with phase(prof, "assemble", device):
        A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                             n_shards)
        b = A.mult(np.ones(A.global_num_rows))

    relax = C.arg(args, 3, RelaxType.SOR, lambda s: RelaxType[s])
    sweeps = C.arg(args, 4, 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=relax)
    ml.num_smooth_sweeps = sweeps
    ml.device = device
    if dtype == torch.float32:
        ml.solve_tol = 1e-5
    with phase(prof, "setup(host)", device):
        ml.setup(A)
    print(ml.print_hierarchy())
    print(ml.print_setup_times())

    with phase(prof, "device plans", device):
        dh = DeviceHierarchy(ml, dtype=dtype, device=device)

    x0 = dh.vector(np.zeros_like(b))
    bd = dh.vector(b)
    with phase(prof, "solve compile+first", device):
        r = dh.solve(x0, bd)
    with phase(prof, "solve (warm)", device):
        r = dh.solve(x0, bd)
        iters = int(r.n_iters)
    print(C.report(prof))
    t = prof.times["solve (warm)"]
    print(f"{iters} V-cycles in {t:.4f}s -> {t / max(1, iters) * 1e3:.2f} "
          f"ms/cycle; rel resid {float(r.res[iters]):.3e}")
    nnz_cycle = sum(lvl.A.nnz for lvl in ml.levels)
    print(f"hierarchy nnz/cycle work: {nnz_cycle}, "
          f"{nnz_cycle * iters / t / 1e9:.3f} Gnnz/s effective")
    return C.finish({"levels": C.levels(ml), "iterations": iters,
                     "residuals": r.res[:iters + 1].tolist(),
                     "nnz_cycle": nnz_cycle}, before)


if __name__ == "__main__":
    main()
