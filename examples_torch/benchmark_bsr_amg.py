"""Blocked (BSR) AMG on plane-stress elasticity, the twin of
examples/benchmark_bsr_amg.py: setup -> blocked V-cycle ->
BSR-preconditioned PCG in float64 (the reference's ParBSR path,
core/par_matrix.hpp:613-699).

Run: python examples_torch/benchmark_bsr_amg.py [nx] [ny] [n_shards] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.fem import par_fem
from raptor_tpu_torch.krylov.cg import cg
from raptor_tpu_torch.multilevel.bsr_hierarchy import (
    BSRDeviceHierarchy, ParBSRRugeStubenSolver)


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    nx = C.arg(args, 0, 64)
    ny = C.arg(args, 1, 32)
    n_shards = C.arg(args, 2, 1)
    before = C.launches()

    A, _ = par_fem("elasticity", nx, ny, n_shards)
    print(f"elasticity {nx}x{ny}: {A.global_num_rows} dofs, "
          f"{A.nnz} nnz")

    ml = ParBSRRugeStubenSolver(2, strong_threshold=0.25)
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    sizes = [lvl.A.global_num_rows for lvl in ml.levels]
    print(f"setup {time.perf_counter() - t0:.2f}s, levels {sizes}")

    dh = BSRDeviceHierarchy(ml, sweeps=3, device=device)
    b = A.mult(np.ones(A.global_num_rows))

    t0 = time.perf_counter()
    x, hist, k = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b),
                          tol=1e-6, max_iter=100)
    hist = hist[hist >= 0]
    print(f"blocked V-cycle: {k} iters to {hist[-1]:.2e} "
          f"({time.perf_counter() - t0:.2f}s incl compile)")

    # the hierarchy's padding, so that its V-cycle takes dA's vectors
    Ab = ml.levels[0].A
    dA = dpar.device_put_matrix(Ab, dtype=torch.float64,
                                lane_pad=dh.lane_pad, need_transpose=False,
                                device=device)
    bb = dpar.device_put_vector(b, Ab.partition.row_bounds, dA.rows_pad,
                                device=device)
    x0 = dpar.device_put_vector(np.zeros_like(b), Ab.partition.row_bounds,
                                dA.rows_pad, device=device)
    t0 = time.perf_counter()
    r = cg(dA, x0, bb, tol=1e-10, max_iter=200, precond=dh.precond_pack())
    it = int(r.n_iters)
    print(f"BSR-PCG: {it} iters to {float(r.res[it]):.2e} "
          f"({time.perf_counter() - t0:.2f}s incl compile)")
    return C.finish({"dofs": A.global_num_rows, "nnz": A.nnz,
                     "level_rows": sizes, "iterations": int(k),
                     "residuals": hist.tolist(), "pcg_iterations": it,
                     "pcg_residuals": r.res[:it + 1].tolist()}, before)


if __name__ == "__main__":
    main()
