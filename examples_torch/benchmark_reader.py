"""Matrix I/O benchmark, the twin of examples/benchmark_reader.py (the
reference's examples/benchmark_reader.cpp): reads a PETSc binary ``.pm``
or MatrixMarket ``.mtx`` file, reports the read time, shape and nnz, and
times 10 float32 SpMVs of the loaded operator behind a synchronize.

The file is required: the JAX script's default, the C++ reference's
test_data/aniso.pm, lies outside this repository, so without a path the
twin stops with a usage error that names it.

Run: python examples_torch/benchmark_reader.py <file.pm|file.mtx> [n_shards] [--device cpu]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.gallery.io import read_mm, read_pm

USAGE = ("give the .pm or .mtx file to read (the JAX script's default is "
         "the C++ reference's test_data/aniso.pm)")


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    if not args:
        raise SystemExit(USAGE)
    path = args[0]
    n_shards = C.arg(args, 1, 1)
    before = C.launches()

    t0 = time.perf_counter()
    a = read_pm(path) if path.endswith(".pm") else read_mm(path)
    t_read = time.perf_counter() - t0
    print(f"read {path}: {a.n_rows} x {a.n_cols}, nnz {a.nnz} "
          f"in {t_read * 1e3:.1f} ms")

    part = Partition.create(a.n_rows, a.n_cols, n_shards)
    A = ParCSRMatrix(a, part)
    dA = dpar.device_put_matrix(A, dtype=torch.float32,
                                lane_pad=C.lane_pad(device), device=device)
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(a.n_cols), part.col_bounds,
        dA.cols_pad, dtype=torch.float32, device=device)

    def ten():
        for _ in range(10):
            b = dpar.spmv(dA, x)
        return b
    dpar.spmv(dA, x)
    dt = C.seconds(device, ten)[1] / 10
    print(f"format {dA.on_format}; SpMV {dt * 1e6:.1f} us "
          f"({a.nnz / dt / 1e9:.2f} Gnnz/s incl dispatch)")
    return C.finish({"n_rows": a.n_rows, "n_cols": a.n_cols, "nnz": a.nnz,
                     "format": dA.on_format, "read_s": t_read,
                     "spmv_s": dt}, before)


if __name__ == "__main__":
    main()
