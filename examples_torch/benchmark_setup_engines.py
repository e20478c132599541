"""Setup-engine shoot-out, the twin of examples/benchmark_setup_engines.py:
the host's native kernels against the card's setup engines for the two
dominant setup phases, interpolation (``device/interp.py``) and the
Galerkin RAP (``device/spgemm.py``). It builds the level-0 operands once,
then times each engine on the same inputs, the card's cold and warm.

The card's engines run in float64, as the port's setup runs them (the
JAX script picks float32 only on a TPU). The twin raises unless the
card's P has the host's pattern and values within 1e-10 (the JAX script
prints the comparison; the twin also holds the card's coarse operator to
the host's the same way).

Run: python examples_torch/benchmark_setup_engines.py [grid_n] [dim] [coarsen] [interp] [--device cpu]
e.g. 128 3 PMIS Extended  (the 128^3 bench config)
     2048 2 RS ModClassical (the 2048^2 bench config)
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from examples_torch import _common as C
from raptor_tpu_torch import native
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import CoarsenType, InterpType, StrengthType
from raptor_tpu_torch.device import spgemm as dsp
from raptor_tpu_torch.device.interp import (extended_interp_device,
                                            mod_classical_interp_device)
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               laplace_stencil_27pt,
                                               par_stencil_grid)
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf
from raptor_tpu_torch.ruge_stuben.interpolation import (
    _coarse_map, extended_interpolation, mod_classical_interpolation)
from raptor_tpu_torch.ruge_stuben.strength import strength
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
from raptor_tpu_torch.utils.hostmem import pin_arena

# the card's P and coarse operator against the host's: max |dv| over max |v|
TOL = 1e-10


def timed(device, label, fn, reps=1):
    """fn() and the least of ``reps`` runs' seconds, printed."""
    best = np.inf
    out = None
    for _ in range(reps):
        out, secs = C.seconds(device, fn)
        best = min(best, secs)
    print(f"  {label:28s} {best:8.3f}s")
    return out, best


def agree(what, host, dev):
    """(pattern equal, max |dv|); raises unless the pattern is the host's
    and the values lie within TOL of max |v|."""
    same = (np.array_equal(host.indptr, dev.indptr)
            and np.array_equal(host.indices, dev.indices))
    dv = float(np.abs(host.data - dev.data).max()) if same else np.inf
    scale = max(1.0, float(np.abs(host.data).max())) if host.nnz else 1.0
    C.check(same and dv <= TOL * scale,
            f"{what}: the card's engine gives pattern_eq={same}, "
            f"max|dv|={dv:.2e} against the host's")
    return same, dv


def main(argv=None):
    args, device = C.parse(argv, __doc__)
    n = C.arg(args, 0, 128)
    dim = C.arg(args, 1, 3)
    coarsen = C.arg(args, 2, CoarsenType.PMIS, lambda s: CoarsenType[s])
    interp = C.arg(args, 3, InterpType.Extended, lambda s: InterpType[s])
    before = C.launches()
    pin_arena(prefault_bytes=6 << 30)

    if dim == 3:
        A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 1)
    else:
        A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8),
                             (n, n), 1)
    a = A.global_csr
    print(f"A: {a.n_rows} rows, {a.nnz} nnz ({device} device)")

    w = form_rand_weights(A.global_num_rows, 0)
    s = strength(A, StrengthType.Classical, 0.25, 1, None)
    split = {CoarsenType.PMIS: cf.split_pmis, CoarsenType.HMIS:
             cf.split_hmis, CoarsenType.CLJP: cf.split_cljp,
             CoarsenType.RS: lambda s, w: cf.split_rs_entry(s)}[coarsen]
    states = np.asarray(split(s, w))
    col_to_new, n_coarse = _coarse_map(states)
    a_indptr, a_indices, _ = a.sorted_csr()
    s_indptr, s_indices, _ = s.global_csr.sorted_csr()
    strong = native.mark_strong(a_indptr, a_indices, s_indptr,
                                s_indices, a.n_rows)

    t = {}
    print("interpolation:")
    if interp == InterpType.Extended:
        kind, host_fn, dev_fn = ("extended+i", extended_interpolation,
                                 extended_interp_device)
    else:
        kind, host_fn, dev_fn = ("mod-classical",
                                 mod_classical_interpolation,
                                 mod_classical_interp_device)
    p, t["host_interp"] = timed(device, f"host native {kind}",
                                lambda: host_fn(a, s.global_csr, states))
    for key, label in (("device_interp", f"device {kind}"),
                       ("device_interp_warm", f"device {kind} (warm)")):
        pd, t[key] = timed(device, label, lambda: dev_fn(
            a, strong, states, col_to_new, n_coarse, device=device))
    same, dv = agree("P", p, pd)
    print(f"  pattern_eq={same} max|dv|={dv:.2e} nnz={p.nnz}")

    print("Galerkin RAP (level 0):")
    P = ParCSRMatrix(p, Partition.create(p.n_rows, p.n_cols, 1))
    ap, t["host_ap"] = timed(device, "host native A*P",
                             lambda: A.multiply(P))
    ac, t["host_ptap"] = timed(device, "host native Pt(AP)",
                               lambda: P.mult_T_mat(ap))
    for key, label in (("device_rap", "device rap (AP + PtAP)"),
                       ("device_rap_warm", "device rap (warm)")):
        (_, acd, _), t[key] = timed(device, label, lambda: dsp.rap_device(
            a, p, need_ap=False, device=device))
    agree("Ac", ac.global_csr.canonicalize(), acd)
    return C.finish({"rows": a.n_rows, "nnz": a.nnz, "pattern_eq": same,
                     "max_dv": dv, "p_nnz": p.nnz, "ac_nnz": acd.nnz,
                     "seconds": t}, before)


if __name__ == "__main__":
    main()
