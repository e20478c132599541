"""CG against AMG-preconditioned CG, the twin of
examples/benchmark_pcg.py (the reference's examples/benchmark_pcg.cpp).

Runs plain CG and AMG-PCG on the rotated anisotropic diffusion problem
and reports iterations and seconds for each (``profile_pcg.py`` splits
an iteration's time). The JAX script runs each solve twice to leave its
compile out of the time; the twin warms each up with a few iterations
instead, then times one whole solve.

Run: python examples_torch/benchmark_pcg.py [grid_n] [n_shards] [f32|f64] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.krylov.cg import cg
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver

WARM_ITERS = 3


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 512)
    n_shards = C.arg(args, 1, C.N_DEV)
    dtype = (torch.float64 if C.arg(args, 2, "f32", str) == "f64"
             else torch.float32)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         n_shards)
    bh = A.mult(np.ones(A.global_num_rows))

    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=dtype, device=device)
    C.sync(device)
    t_plan = time.perf_counter() - t0

    dA = dh.levels[0].A
    x0 = dh.vector(np.zeros_like(bh))
    b = dh.vector(bh)
    tol = 1e-5 if dtype == torch.float32 else 1e-8

    # plain CG (warm up, then time)
    cg(dA, x0, b, tol=tol, max_iter=WARM_ITERS)
    r, t_cg = C.seconds(device, lambda: cg(dA, x0, b, tol=tol,
                                           max_iter=20000))
    cg_iters = int(r.n_iters)

    # AMG-PCG with the hierarchy's one V-cycle
    pp = dh.precond_pack()
    cg(dA, x0, b, tol=tol, max_iter=WARM_ITERS, precond=pp)
    rp, t_pcg = C.seconds(device, lambda: cg(dA, x0, b, tol=tol,
                                             max_iter=200, precond=pp))
    pcg_iters = int(rp.n_iters)

    print(f"setup(host) {t_setup:.2f}s, device plans {t_plan:.2f}s")
    print(f"CG    : {cg_iters:4d} iters in {t_cg:.3f}s "
          f"({t_cg / max(1, cg_iters) * 1e3:.2f} ms/iter)")
    print(f"AMG-PCG: {pcg_iters:4d} iters in {t_pcg:.3f}s "
          f"({t_pcg / max(1, pcg_iters) * 1e3:.2f} ms/iter)")
    return C.finish({"levels": C.levels(ml), "cg_iterations": cg_iters,
                     "cg_residuals": r.res[:cg_iters + 1].tolist(),
                     "pcg_iterations": pcg_iters,
                     "pcg_residuals": rp.res[:pcg_iters + 1].tolist()},
                    before)


if __name__ == "__main__":
    main()
