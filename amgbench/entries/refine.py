"""Mixed-precision iterative refinement: ``DeviceHierarchy.solve_mixed``,
float64 residuals against the fine operator with the hierarchy's V-cycle
(in the mix's ``precision``) as the correction, to the mix's ``tol`` within
``max_iter`` refinements.

Its control computes the residual in float32 as well: the float32
hierarchy's own ``DeviceHierarchy.solve``, whose float32 residual cannot
resolve a float64 tolerance."""

import numpy as np
import torch

from amgbench.entries import Solve
from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy


class Refine:
    def __init__(self, ml, mix, device):
        self.dh = DeviceHierarchy(ml, dtype=getattr(torch, mix["precision"]),
                                  device=device)
        self.tol, self.max_iter = mix["tol"], mix["max_iter"]
        self.x0 = np.zeros(ml.levels[0].A.global_num_rows)
        # a zero right-hand side returns at once, having packed the float64
        # fine operator of the residuals
        self.dh.solve_mixed(self.x0, self.x0)

    def solve(self, b: np.ndarray) -> Solve:
        x, hist = self.dh.solve_mixed(self.x0, b, tol=self.tol,
                                      max_iter=self.max_iter)
        return Solve(x, len(hist) - 1, float(hist[-1]),
                     bool(hist[-1] <= self.tol))


class Float32Solve:
    def __init__(self, ml, mix, device):
        self.dh = DeviceHierarchy(ml, dtype=torch.float32, device=device)
        self.dh.solve_tol, self.dh.max_iterations = mix["tol"], mix["max_iter"]
        self.x0 = np.zeros(ml.levels[0].A.global_num_rows)

    def solve(self, b: np.ndarray) -> Solve:
        out = self.dh.solve(self.dh.vector(self.x0), self.dh.vector(b))
        res = float(out.res[out.n_iters])
        return Solve(self.dh.host(out.x).astype(np.float64), out.n_iters,
                     res, res <= self.dh.solve_tol)


def prepare(ml, mix, device) -> Refine:
    return Refine(ml, mix, device)


def prepare_control(ml, mix, device) -> Float32Solve:
    return Float32Solve(ml, mix, device)
