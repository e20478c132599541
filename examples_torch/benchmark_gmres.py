"""GMRES(m) against AMG-preconditioned GMRES on a nonsymmetric
convection-diffusion operator, the twin of examples/benchmark_gmres.py
(beyond the reference, whose Krylov layer stops at CG / BiCGStab).

The twin runs in float64, as the reference does. The JAX script leaves
JAX's 64-bit mode off, so there the same calls run in float32, in which
the 1e-8 asked for lies below the rounding and the iteration count is
the rounding's; with JAX_ENABLE_X64=1 it runs in float64 too. It runs
each solve twice to leave its compile out of the time; the twin warms
each up with a few iterations instead.

Run: python examples_torch/benchmark_gmres.py [grid_n] [n_shards] [restart] [--device cpu]
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
from raptor_tpu_torch.gallery.stencils import par_stencil_grid
from raptor_tpu_torch.krylov.gmres import gmres
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver

WARM_ITERS = 3


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 256)
    n_shards = C.arg(args, 1, C.N_DEV)
    restart = C.arg(args, 2, 30)
    before = C.launches()

    # upwind convection-diffusion: nonsymmetric, diagonally dominant
    st = np.array([[0.0, -1.0, 0.0],
                   [-1.8, 5.0, -0.2],
                   [0.0, -1.0, 0.0]])
    A = par_stencil_grid(st, (n, n), n_shards)
    bh = A.mult(np.ones(A.global_num_rows))

    # the padding of the hierarchy below, whose V-cycle takes dA's vectors
    dA = dpar.device_put_matrix(A, dtype=torch.float64,
                                lane_pad=C.lane_pad(device), device=device)
    x = dpar.device_put_vector(np.zeros_like(bh), A.partition.row_bounds,
                               dA.rows_pad, device=device)
    b = dpar.device_put_vector(bh, A.partition.row_bounds, dA.rows_pad,
                               device=device)

    gmres(dA, x, b, tol=1e-8, restart=restart, max_iter=WARM_ITERS)
    r, t_plain = C.seconds(device, lambda: gmres(
        dA, x, b, tol=1e-8, restart=restart, max_iter=500))
    print(f"GMRES({restart}): {int(r.n_iters)} iters {t_plain:.3f}s "
          f"rel resid {float(r.res[int(r.n_iters)]):.3e}")

    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP,
                             InterpType.ModClassical,
                             relax_type=RelaxType.SOR)
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    t_setup = time.perf_counter() - t0
    dh = DeviceHierarchy(ml, device=device)
    pk = dh.precond_pack()
    gmres(dA, x, b, tol=1e-8, restart=restart, max_iter=WARM_ITERS,
          precond=pk)
    rp, t_pre = C.seconds(device, lambda: gmres(
        dA, x, b, tol=1e-8, restart=restart, precond=pk))
    print(f"AMG-GMRES: {int(rp.n_iters)} iters {t_pre:.3f}s "
          f"(+{t_setup:.2f}s setup) "
          f"rel resid {float(rp.res[int(rp.n_iters)]):.3e}")

    xh = dpar.host_vector(rp.x, A.partition.row_bounds)
    true_res = float(np.linalg.norm(bh - A.mult(xh)) / np.linalg.norm(bh))
    print("true rel resid:", true_res)
    return C.finish({"gmres_iterations": int(r.n_iters),
                     "gmres_residuals": r.res[:r.n_iters + 1].tolist(),
                     "levels": C.levels(ml),
                     "amg_gmres_iterations": int(rp.n_iters),
                     "amg_gmres_residuals": rp.res[:rp.n_iters + 1].tolist(),
                     "true_residual": true_res}, before)


if __name__ == "__main__":
    main()
