"""Per-phase AMG profile, the twin of examples/profile_amg.py: setup
splits by level + per-level V-cycle timing + solve history (the
reference's examples/profile_amg.cpp, profile_rss.cpp and
profile_tap_amg.cpp, which print strength / split / interp / RAP per
level and relax / spmv / transfer per cycle level via track_times,
multilevel/par_multilevel.hpp:127-205,412-457).

The shards are the 8 of the JAX package's device mesh, stacked on one
device. Where the JAX script solves once to compile before the timed
solve, the twin runs one V-cycle, whose seconds it prints in the
"compile+first" place.

Run: python examples_torch/profile_amg.py [grid_n] [coarsen] [interp] [tap] [--device cpu]
  coarsen in {RS,CLJP,Falgout,PMIS,HMIS}; interp in
  {Direct,ModClassical,Extended}; tap=1 profiles the same hierarchy
  again with the topology-aware exchange on every level (2 x 4 layout).
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 512)
    coarsen = C.arg(args, 1, CoarsenType.HMIS, lambda s: CoarsenType[s])
    interp = C.arg(args, 2, InterpType.Extended, lambda s: InterpType[s])
    tap = len(args) > 3 and args[3] not in ("0", "")
    n_dev = C.N_DEV
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         n_dev)
    ml = ParRugeStubenSolver(strong_threshold=0.25, coarsen_type=coarsen,
                             interp_type=interp,
                             relax_type=RelaxType.SOR)
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    t_setup = time.perf_counter() - t0
    print(ml.print_hierarchy())
    print(f"setup: {t_setup:.3f}s; per-level phase splits (s):")
    print(ml.print_setup_times())

    ml.solve_tol = 1e-6  # f32 hierarchy: don't burn cycles at the floor
    dh = DeviceHierarchy(ml, dtype=torch.float32, device=device)
    b_host = A.mult(np.ones(A.global_num_rows))
    b = dh.vector(b_host)
    x = dh.vector(np.zeros(A.global_num_rows))
    _, t_first = C.seconds(device, lambda: C.warm_up(dh, x, b))
    res, t_solve = C.seconds(device, lambda: dh.solve(x, b))
    it = int(res.n_iters)
    print(f"\nsolve: {it} V-cycles to rel resid "
          f"{float(res.res[it]):.3e} in {t_solve:.3f}s warm "
          f"({t_first:.1f}s compile+first)")
    print("per-level cycle splits:")
    print(dh.print_times(reps=10))
    out = {"levels": C.levels(ml), "iterations": it,
           "residuals": res.res[:it + 1].tolist()}

    if tap and n_dev >= 4 and n_dev % 2 == 0:
        mesh2 = dpar.make_mesh2(2, n_dev // 2)
        ml.tap_amg = 0
        dh2 = DeviceHierarchy(ml, dtype=torch.float32, device=device,
                              mesh=mesh2)
        x2, b2 = dh2.vector(np.zeros(A.global_num_rows)), dh2.vector(b_host)
        dh2.solve(x2, b2)
        r2, t_tap = C.seconds(device, lambda: dh2.solve(x2, b2))
        print(f"\nTAP 2x{n_dev // 2} mesh: {int(r2.n_iters)} V-cycles "
              f"in {t_tap:.3f}s warm")
        out["tap_iterations"] = int(r2.n_iters)
    return C.finish(out, before)


if __name__ == "__main__":
    main()
