"""PCG per-phase time splits, the twin of examples/profile_pcg.py: the
reference's comm_t / precond_t out-parameters (krylov/par_cg.cpp:121-239;
examples/benchmark_pcg.cpp reporting), measured by chained component
timing (``krylov.profile.pcg_time_split``: CUDA events around each step
on the card).

Run: python examples_torch/profile_pcg.py [grid_n] [n_shards] [--device cpu]
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
from raptor_tpu_torch.krylov.cg import cg
from raptor_tpu_torch.krylov.profile import pcg_time_split
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 256)
    n_shards = C.arg(args, 1, C.N_DEV)
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         n_shards)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP,
                             InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.device = device
    ml.setup(A)
    dh = DeviceHierarchy(ml, dtype=torch.float32, device=device)
    # the hierarchy's padding, so that its V-cycle takes dA's vectors
    dA = dpar.device_put_matrix(A, dtype=torch.float32,
                                lane_pad=dh.lane_pad, need_transpose=False,
                                device=device)
    b = A.mult(np.ones(A.global_num_rows))
    bv = dpar.device_put_vector(b, A.partition.row_bounds, dA.rows_pad,
                                dtype=torch.float32, device=device)

    split = pcg_time_split(dA, bv, precond=dh.precond_pack())
    tot = split["total_t"]
    print(f"{n}x{n}, {n_shards} shards — per PCG iteration:")
    for k in ("total_t", "precond_t", "spmv_t", "comm_t"):
        frac = split[k] / tot if tot else 0.0
        print(f"  {k:10s} {split[k] * 1e6:10.1f} us  ({100 * frac:5.1f}%)")

    x0 = dpar.device_put_vector(np.zeros_like(b), A.partition.row_bounds,
                                dA.rows_pad, dtype=torch.float32,
                                device=device)
    t0 = time.perf_counter()
    r = cg(dA, x0, bv, tol=1e-5, max_iter=100, precond=dh.precond_pack())
    it = int(r.n_iters)
    print(f"PCG: {it} iters to {float(r.res[it]):.2e} "
          f"({time.perf_counter() - t0:.2f}s incl compile)")
    return C.finish({"levels": C.levels(ml), "pcg_iterations": it,
                     "residuals": r.res[:it + 1].tolist(),
                     "split_s": dict(split)}, before)


if __name__ == "__main__":
    main()
