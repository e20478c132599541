"""SpGEMM / Galerkin triple-product benchmark, the twin of
examples/benchmark_spgemm.py (the reference's benchmark_matmult.cpp,
benchmark_spgemm_overlap.cpp): times A*P and P^T(AP) per level of an RS
hierarchy and reports output nnz/s. On the card the setup's default
engines ("auto") run the Galerkin product of a level of at least
2,000,000 nonzeros on the device.

Run: python examples_torch/benchmark_spgemm.py [grid_n] [coarsen] [interp] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 1024)
    coarsen = C.arg(args, 1, CoarsenType.RS, lambda s: CoarsenType[s])
    interp = C.arg(args, 2, InterpType.ModClassical, lambda s: InterpType[s])
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    ml = ParRugeStubenSolver(0.25, coarsen, interp)
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    C.sync(device)
    total = time.perf_counter() - t0

    print(f"{'lvl':>3} {'nnz(AP)+nnz(Ac)':>16} {'seconds':>9} "
          f"{'nnz/s':>12}")
    for lvl, nnz_out, secs in ml.rap_stats:
        print(f"{lvl:3d} {nnz_out:16d} {secs:9.3f} "
              f"{nnz_out / max(secs, 1e-9):12.3e}")
    rap_t = sum(s[2] for s in ml.rap_stats)
    rap_nnz = sum(s[1] for s in ml.rap_stats)
    print(f"total RAP {rap_t:.2f}s of {total:.2f}s setup; "
          f"{rap_nnz / max(rap_t, 1e-9):.3e} nnz/s")
    return C.finish({"levels": C.levels(ml),
                     "rap_nnz": [int(s[1]) for s in ml.rap_stats],
                     "rap_engines": [e.get("rap") for e in ml.level_engines]},
                    before)


if __name__ == "__main__":
    main()
