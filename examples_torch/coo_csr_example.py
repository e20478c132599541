"""Container round-trip demo, the twin of examples/coo_csr_example.py:
fill a random ParCOO, convert to ParCSR, run an SpMV on the host and on
the device (the reference's examples/coo_example.cpp + csr_example.cpp).

The reference builds a random n x m ParCOOMatrix with add_value, unit
diagonal, converts to ParCSRMatrix and checks ``|Ax|`` agreement between
the two formats (coo_example.cpp:17-80). Here the same flow runs over the
sharded containers and checks the device SpMV over the stacked shards
against the host product.

Run: python examples_torch/coo_csr_example.py [n] [m] [n_shards] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.par_matrix import ParCOOMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.device import par as dpar


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 64)
    m = C.arg(args, 1, 64)
    n_shards = C.arg(args, 2, 4)
    before = C.launches()

    rng = np.random.default_rng(42)
    part = Partition.create(n, m, n_shards)

    # unit diagonal + random off-diagonal entries, added in COO order
    coo = ParCOOMatrix(part)
    for i in range(n):
        coo.add_global_value(i, i % m, 1.0)
    nnz_extra = int(rng.integers(n, 4 * n))
    rows = rng.integers(0, n, nnz_extra)
    cols = rng.integers(0, m, nnz_extra)
    vals = rng.random(nnz_extra)
    coo.add_values(rows, cols, vals)

    a = coo.finalize()
    print(f"ParCOO -> ParCSR: global {a.global_num_rows}x{a.global_num_cols}, "
          f"nnz={a.nnz}, shards={a.n_shards}")

    x = rng.random(a.global_num_cols)
    y_host = a.mult(x)
    print(f"host SpMV  |Ax|_2 = {np.linalg.norm(y_host):.12e}")
    out = {"shape": [a.global_num_rows, a.global_num_cols], "nnz": a.nnz,
           "n_shards": a.n_shards,
           "host_norm": float(np.linalg.norm(y_host))}

    if a.global_num_cols == a.global_num_rows:
        A = dpar.device_put_matrix(a, dtype=torch.float64,
                                   lane_pad=C.lane_pad(device),
                                   device=device)
        xd = dpar.device_put_vector(x, a.partition.col_bounds, A.cols_pad,
                                    device=device)
        yd = dpar.host_vector(dpar.spmv(A, xd), a.partition.row_bounds)
        diff = float(np.abs(yd - y_host).max())
        print(f"device SpMV |Ax|_2 = {np.linalg.norm(yd):.12e} "
              f"(max |host-dev| = {diff:.3e})")
        C.check(diff < 1e-10, f"device SpMV {diff} from the host one")
        out.update(device_norm=float(np.linalg.norm(yd)), max_diff=diff)

    print("ok")
    return C.finish(out, before)


if __name__ == "__main__":
    main()
