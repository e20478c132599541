"""Topology-aware AMG benchmark, the twin of examples/benchmark_tap_amg.py
(the reference's examples/benchmark_tap_amg.cpp): the same hierarchy
solved with the plain halo exchange and with the TAP schedule on a
(host, local) layout of the 8 stacked shards, from every activation
level.

The reference times V-cycles with tap_amg = 0 (all levels) after
building TAPComm on each level; here ``tap_amg`` sweeps which levels get
the staged exchange, mirroring the reference's tap_amg knob
(multilevel/par_multilevel.hpp:111 tap_amg). Where the JAX script solves
once to compile before the timed solve, the twin runs one V-cycle; the
solve is timed by CUDA events behind a synchronize on the card.

Run: python examples_torch/benchmark_tap_amg.py [grid_n] [hosts] [--device cpu]
"""

import pathlib
import sys

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


def timed_solve(dh, b, device):
    x0 = dh.vector(np.zeros_like(b))
    bd = dh.vector(b)
    C.warm_up(dh, x0, bd)           # the JAX script's compile
    r, dt = C.seconds(device, lambda: dh.solve(x0, bd))
    return int(r.n_iters), dt


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 512)
    n_dev = C.N_DEV
    hosts = C.arg(args, 1, 2)
    C.check(n_dev % hosts == 0, "hosts must divide the shard count")
    local = n_dev // hosts
    before = C.launches()

    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         n_dev)
    b = A.mult(np.ones(A.global_num_rows))

    ml = ParRugeStubenSolver(0.25, CoarsenType.HMIS, InterpType.Extended,
                             relax_type=RelaxType.SOR)
    ml.solve_tol = 1e-6
    ml.device = device
    ml.setup(A)
    print(ml.print_hierarchy())
    n_levels = len(ml.levels)

    # plain halo exchange
    dh = DeviceHierarchy(ml, dtype=torch.float32, device=device)
    iters, dt = timed_solve(dh, b, device)
    print(f"plain   1x{n_dev}: {iters} V-cycles {dt:.4f}s "
          f"({dt / max(1, iters) * 1e3:.2f} ms/cycle)")
    out = {"levels": C.levels(ml), "plain": iters, "tap": {}}

    # TAP from level k on the (hosts, local) layout
    mesh2 = dpar.make_mesh2(hosts, local)
    for k in range(n_levels - 1, -1, -1):
        ml.tap_amg = k
        dh2 = DeviceHierarchy(ml, dtype=torch.float32, device=device,
                              mesh=mesh2)
        iters, dt = timed_solve(dh2, b, device)
        print(f"tap>={k} {hosts}x{local}: {iters} V-cycles {dt:.4f}s "
              f"({dt / max(1, iters) * 1e3:.2f} ms/cycle)")
        out["tap"][k] = iters
    ml.tap_amg = -1
    return C.finish(out, before)


if __name__ == "__main__":
    main()
