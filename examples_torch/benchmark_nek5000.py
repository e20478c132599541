"""Real-matrix AMG-PCG benchmark, the twin of examples/benchmark_nek5000.py
(the reference's examples/benchmark_nek5000.cpp): load an operator from
disk (MatrixMarket / .pm; the reference reads a nek5000 pressure matrix,
LFAT5.mtx ships with its examples), compare the halo of three row
partitions (contiguous, RCM banding, native k-way), repartition by k-way,
build the Ruge-Stuben hierarchy and solve with AMG-preconditioned CG in
float64 to 1e-8 over the stacked shards.

The file is required: the JAX script's default, the C++ reference's
examples/LFAT5.mtx, lies outside this repository, so without a path the
twin stops with a usage error that names it. The default shard count is
the JAX script's ``min(4, len(jax.devices()))`` on its 8-device mesh.

Run: python examples_torch/benchmark_nek5000.py <file.mtx|file.pm> [n_shards] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.gallery.io import read_mm, read_pm
from raptor_tpu_torch.krylov.cg import cg
from raptor_tpu_torch.linalg.repartition import (comm_volume,
                                                 partition_graph,
                                                 repartition_matrix)
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
from raptor_tpu_torch.multilevel.par_multilevel import ParRugeStubenSolver

USAGE = ("give the .mtx or .pm file to read (the JAX script's default is "
         "the C++ reference's examples/LFAT5.mtx)")


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    if not args:
        raise SystemExit(USAGE)
    path = args[0]
    n_shards = C.arg(args, 1, min(4, C.N_DEV))
    before = C.launches()

    t0 = time.perf_counter()
    a = read_pm(path) if path.endswith(".pm") else read_mm(path)
    t_read = time.perf_counter() - t0
    print(f"read {path}: {a.n_rows} x {a.n_cols}, nnz {a.nnz} "
          f"({t_read:.3f} s)")

    part = Partition.create(a.n_rows, a.n_cols, n_shards)
    A = ParCSRMatrix(a, part)

    # quality repartition (the reference's ParMETIS step): native
    # multilevel k-way against contiguous rows and RCM banding, by halo
    n = A.global_num_rows
    naive = comm_volume(A, np.repeat(np.arange(n_shards),
                                     -(-n // n_shards))[:n])
    t0 = time.perf_counter()
    proc = partition_graph(A, n_shards, method="kway")
    t_kway = time.perf_counter() - t0
    vk = comm_volume(A, proc)
    vr = comm_volume(A, partition_graph(A, n_shards, method="rcm"))
    print(f"partition halo_values: naive {naive['halo_values']}, "
          f"rcm {vr['halo_values']}, kway {vk['halo_values']} "
          f"(edge cut {naive['edge_cut']}/{vr['edge_cut']}/"
          f"{vk['edge_cut']}; kway {t_kway:.3f} s)")
    A, _ = repartition_matrix(A, proc)

    rng = np.random.default_rng(0)
    b = A.mult(rng.random(A.global_num_rows))

    ml = ParRugeStubenSolver(0.25)
    ml.device = device
    t0 = time.perf_counter()
    ml.setup(A)
    t_setup = time.perf_counter() - t0
    print(f"setup {t_setup:.3f} s")
    print(ml.print_hierarchy())

    dh = DeviceHierarchy(ml, device=device)
    r, t_solve = C.seconds(device, lambda: cg(
        dh.levels[0].A, dh.vector(np.zeros_like(b)), dh.vector(b),
        tol=1e-8, max_iter=200, precond=dh.precond_pack()))
    it = int(r.n_iters)
    hist = r.res[:it + 1]
    print(f"AMG-PCG: {it} iters, final rel res {float(hist[-1]):.3e}")
    return C.finish({
        "n_rows": a.n_rows, "nnz": a.nnz,
        "halo_values": {"naive": naive["halo_values"],
                        "rcm": vr["halo_values"], "kway": vk["halo_values"]},
        "edge_cut": {"naive": naive["edge_cut"], "rcm": vr["edge_cut"],
                     "kway": vk["edge_cut"]},
        "levels": C.levels(ml), "pcg_iterations": it,
        "residuals": hist.tolist(), "read_s": t_read, "setup_s": t_setup,
        "solve_s": t_solve}, before)


if __name__ == "__main__":
    main()
