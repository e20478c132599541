"""Transfer-operator format shoot-out, the twin of
examples/benchmark_transfer_formats.py: auto against windowed ELL, the
sorted-scatter transpose, BELL and ELL on the level-0 P / P^T of a 3-D
PMIS + extended+i hierarchy.

It builds the hierarchy at ``grid_n^3`` (its P and P^T kept in ``cache``
as npz, so a rerun skips the setup), packs P (embedded by columns) and
P^T (by rows) in float32 in each format, holds each pack's product to the
host's, and times one apply by the delta of two chains of dependent
applies (CUDA events behind a synchronize on the card). The JAX script
reports a format that fails as FAILED and goes on; here a format that
fails to pack or apply raises. "auto" is the port's choice by the bytes
an apply streams (``device/par.py:_transfer_bytes``), which need not be
the JAX package's.

Run: python examples_torch/benchmark_transfer_formats.py [grid_n] [cache] [format] [--device cpu]
"""

import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np
import torch

from examples_torch import _common as C
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.device import par as dpar

FORMATS = (None, "well", "wellt", "bell", "ell")
# an apply's error against the host product, over max(1, max |product|)
TOL = 1e-4


def build_or_load(n, cache, device):
    """{"P": level 0's P, "Pt": its transpose} of the n^3 hierarchy, from
    ``cache`` when both files are there, else set up and saved there."""
    ops = {}
    files = {k: os.path.join(cache, f"transfer{n}_{k}.npz")
             for k in ("P", "Pt")}
    if all(os.path.exists(f) for f in files.values()):
        for k, f in files.items():
            z = np.load(f)
            ops[k] = CSRMatrix(int(z["n_rows"]), int(z["n_cols"]),
                               z["indptr"], z["indices"], z["data"])
        return ops
    from raptor_tpu_torch.core.types import CoarsenType, InterpType
    from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                                   par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    from raptor_tpu_torch.utils.hostmem import pin_arena
    pin_arena(prefault_bytes=4 << 30)
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended)
    ml.device = device
    ml.setup(A)
    ops["P"] = ml.levels[0].P._g()
    ops["Pt"] = ml.levels[0].P.transpose()._g()
    for k, f in files.items():
        g = ops[k]
        np.savez(f, indptr=g.indptr, indices=g.indices, data=g.data,
                 n_rows=g.n_rows, n_cols=g.n_cols)
    return ops


def chain(dA, x, k):
    """k dependent applies: a numerically negligible function of each
    product is fed back into x (the JAX script's loop, whose dependence
    keeps XLA from hoisting the product)."""
    for _ in range(k):
        b = dpar.spmv(dA, x)
        x = x * (1.0 + 1e-30 * b.sum())
    return x.sum()


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 48)
    cache = args[1] if len(args) > 1 else tempfile.gettempdir()
    only = args[2] if len(args) > 2 else None
    fmts = FORMATS if only is None else \
        ((None,) if only == "auto" else (only,))
    before = C.launches()
    ops = build_or_load(n, cache, device)
    out = {}
    for name, embed in (("P", "cols"), ("Pt", "rows")):
        a = ops[name]
        A = ParCSRMatrix(a, Partition.create(a.n_rows, a.n_cols, 1))
        print(f"== {name}: {a.n_rows} x {a.n_cols}, nnz {a.indptr[-1]} ==")
        xh = np.random.default_rng(0).random(a.n_cols)
        ref = a.mult(xh)
        rows = out[name] = {}
        for fmt in fmts:
            dA = dpar.device_put_matrix(
                A, dtype=torch.float32, lane_pad=128, force_format=fmt,
                need_transpose=False, embed=embed, device=device)
            x = dpar.device_put_vector(xh, A.partition.col_bounds,
                                       dA.cols_pad, dtype=torch.float32,
                                       device=device)
            y = dpar.spmv(dA, x)
            yh = dpar.host_vector(y, A.partition.row_bounds)
            err = float(np.abs(yh - ref).max()
                        / max(1.0, np.abs(ref).max()))
            label = fmt or "auto"
            C.check(err < TOL, f"{name} {label}({dA.on_format}): error "
                    f"{err:.1e} against the host product")
            per = C.delta_time(device, chain, dA, x, n_lo=2, n_hi=52)
            print(f"  {label + '(' + dA.on_format + ')':20s}"
                  f": {per * 1e3:8.3f} ms/apply  (err {err:.1e})")
            rows[label] = {"format": dA.on_format, "err": err,
                           "ms": per * 1e3}
    return C.finish(out, before)


if __name__ == "__main__":
    main()
