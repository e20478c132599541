"""Serial host V-cycle solver (copy of raptor_tpu.multilevel.serial): the
reference's serial ``Multilevel`` (multilevel/multilevel.hpp:24-273) over a
set-up hierarchy, with numpy vectors and sequential Gauss-Seidel sweeps.
An oracle for the device solver, whose one-shard results it matches."""

from __future__ import annotations

import numpy as np
import scipy.linalg

from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel


def _relax_host(a_csr, x, b, kind: RelaxType, sweeps: int, omega: float):
    m = a_csr.to_scipy()
    m.sort_indices()
    diag = m.diagonal()
    indptr, indices, data = m.indptr, m.indices, m.data
    n = len(x)
    for _ in range(sweeps):
        if kind == RelaxType.Jacobi:
            row_sum = m @ x - diag * x
            x = np.where(np.abs(diag) > 1e-16,
                         (1 - omega) * x + omega * (b - row_sum) / diag, x)
        else:
            sweeps_dirs = (["fwd"] if kind == RelaxType.SOR
                           else ["fwd", "bwd"])
            for d in sweeps_dirs:
                order = range(n) if d == "fwd" else range(n - 1, -1, -1)
                for i in order:
                    cols = indices[indptr[i]:indptr[i + 1]]
                    vals = data[indptr[i]:indptr[i + 1]]
                    sel = cols != i
                    rs = vals[sel] @ x[cols[sel]]
                    if d == "fwd":
                        # the reference's non-standard forward update
                        x[i] = (x[i] + omega * (b[i] - x[i] - rs)) / diag[i]
                    else:
                        x[i] = (1 - omega) * x[i] + omega * (b[i] - rs) \
                            / diag[i]
    return x


class SerialMultilevel:
    """Host solve over an already set-up ParMultilevel hierarchy."""

    def __init__(self, ml: ParMultilevel):
        if ml.num_levels == 0:
            raise ValueError("setup() the hierarchy first")
        self.ml = ml

    def cycle(self, x: np.ndarray, b: np.ndarray, level: int = 0):
        ml = self.ml
        if level == ml.num_levels - 1:
            return scipy.linalg.lu_solve(ml.coarse_lu, b)
        lvl = ml.levels[level]
        a, p = lvl.A.global_csr, lvl.P.global_csr
        x = _relax_host(a, x.copy(), b, ml.relax_type,
                        ml.num_smooth_sweeps, ml.relax_weight)
        r = b - a.mult(x)
        bc = p.mult_T(r)
        xc = self.cycle(np.zeros(len(bc)), bc, level + 1)
        x = x + p.mult(xc)
        x = _relax_host(a, x, b, ml.relax_type, ml.num_smooth_sweeps,
                        ml.relax_weight)
        return x

    def solve(self, x: np.ndarray, b: np.ndarray):
        """V-cycles to ``ml.solve_tol`` relative residual, at most
        ``ml.max_iterations``: (x, residual history, cycles)."""
        ml = self.ml
        a = ml.levels[0].A.global_csr
        b_norm = np.linalg.norm(b)
        scale = b_norm if b_norm > 1e-16 else 1.0
        residuals = [np.linalg.norm(b - a.mult(x)) / scale]
        it = 0
        while residuals[-1] > ml.solve_tol and it < ml.max_iterations:
            x = self.cycle(x, b)
            residuals.append(np.linalg.norm(b - a.mult(x)) / scale)
            it += 1
        return x, np.array(residuals), it
