"""Matrix-operation demo, the twin of examples/matop_example.py: add /
subtract / diagonal / transpose / multiply on serial and parallel
containers (the reference's examples/matop_example.cpp), each checked
against scipy.

The operations run on the host, in both packages; the device is only
checked for (``--device``), as in every twin.

Run: python examples_torch/matop_example.py [grid_n] [n_shards] [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               par_stencil_grid,
                                               stencil_grid)


def main(argv=None):
    args, _ = C.parse(argv, __doc__)
    n = C.arg(args, 0, 32)
    n_shards = C.arg(args, 1, 4)
    before = C.launches()

    s1 = diffusion_stencil_2d(1.0, 0.0)
    s2 = diffusion_stencil_2d(0.001, np.pi / 8)

    # serial CSR ops
    A = stencil_grid(s1, (n, n))
    B = stencil_grid(s2, (n, n))
    C_ = A.add(B)
    D = A.subtract(B)
    a, b = A.to_scipy(), B.to_scipy()
    C.check(abs(C_.to_scipy() - (a + b)).max() < 1e-14, "serial add")
    C.check(abs(D.to_scipy() - (a - b)).max() < 1e-14, "serial subtract")
    print(f"serial add/subtract ok  (n={A.n_rows}, nnz={A.indptr[-1]})")

    # parallel ops over the sharded containers
    Ap = par_stencil_grid(s1, (n, n), n_shards)
    Bp = par_stencil_grid(s2, (n, n), n_shards)
    Cp = Ap.add(Bp)
    Dp = Ap.subtract(Bp)
    x = np.random.default_rng(7).random(Ap.global_num_cols)
    C.check(np.abs(Cp.mult(x) - (a + b) @ x).max() < 1e-12, "parallel add")
    C.check(np.abs(Dp.mult(x) - (a - b) @ x).max() < 1e-12,
            "parallel subtract")
    print(f"parallel add/subtract ok ({n_shards} shards)")

    # diagonal + transpose
    d = Ap.diagonal()
    C.check(np.abs(d - a.diagonal()).max() < 1e-14, "diagonal")
    At = Ap.transpose()
    C.check(np.abs(At.mult(x) - a.T @ x).max() < 1e-12, "transpose")
    print("diagonal + distributed transpose ok")

    # the parallel product A B against scipy's
    AP = Ap.multiply(Bp)
    C.check(abs(AP.mult(x) - a @ (b @ x)).max() < 1e-10, "multiply")
    print("parallel multiply ok")
    print("ok")
    return C.finish({"n": A.n_rows, "nnz": int(A.indptr[-1]),
                     "n_shards": n_shards, "product_nnz": AP.nnz}, before)


if __name__ == "__main__":
    main()
