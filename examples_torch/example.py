"""Canonical usage example, the twin of examples/example.py for the
PyTorch / CUDA port (the reference's examples/example.cpp, the README
run: 2-D rotated anisotropic diffusion, CLJP coarsening + modified
classical interpolation + SOR smoothing, theta = 0.25, float64).

Run:  python examples_torch/example.py [grid_n] [n_shards] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 100)
    n_shards = C.arg(args, 1, C.N_DEV)
    before = C.launches()

    # assemble the problem
    stencil = diffusion_stencil_2d(eps=0.001, theta=np.pi / 8)
    A = par_stencil_grid(stencil, (n, n), n_shards)
    x_true = np.ones(A.global_num_rows)
    b = A.mult(x_true)

    # AMG setup (host) — strength -> CLJP -> mod classical P -> RAP per level
    ml = ParRugeStubenSolver(
        strong_threshold=0.25,
        coarsen_type=CoarsenType.CLJP,
        interp_type=InterpType.ModClassical,
        relax_type=RelaxType.SOR)
    ml.device = device
    ml.setup(A)
    print(ml.print_hierarchy())

    # device solve (V-cycles over the stacked shards)
    dh = DeviceHierarchy(ml, device=device)
    result = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))

    iters = int(result.n_iters)
    print(f"solved in {iters} V-cycles")
    for k in range(iters + 1):
        print(f"  iter {k:3d}: rel resid {float(result.res[k]):.6e}")

    x = dh.host(result.x)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"solution error vs exact: {err:.3e}")
    return C.finish({"levels": C.levels(ml), "iterations": iters,
                     "residuals": result.res[:iters + 1].tolist(),
                     "error": float(err)}, before)


if __name__ == "__main__":
    main()
