"""Conjugate gradient, plain and AMG-preconditioned (copy of
raptor_tpu.krylov.cg).

Semantics match the reference (krylov/par_cg.cpp):
- ``res[k] = ||r_k|| / ||b||`` with ``||b||`` clamped to 1 when ~0 (:21-22)
- convergence on ``||r|| <= tol * ||r_0||`` (:47-50)
- the true residual ``b - Ax`` is recomputed when ``k % 8 == 0`` (k counted
  before the increment), otherwise ``r -= alpha A p`` (:51-52, :75-83)
- default ``max_iter = 1.3 n + 2`` (:24-27)
- an indefiniteness flag replaces the reference's abort (:63-70)

The iteration is a Python loop on the device its tensors are on (there is
no mesh argument: the shards are the leading axis of the stacked tensors).
Across controllers (a matrix with a ``comm``, one shard each) every
controller runs the same loop on its shard; the inner products gather the
per-shard dots into shard order (``device.par.dot``), so each controller
takes the same steps and the iteration of the stacked route. Scalars stay
on the device in the solve's dtype; the host reads ``||r||`` back once per
iteration for the loop test. The solve is the span ``raptor.cg``, each
iteration ``raptor.cg.iter``, each read back ``raptor.sync`` (one of the
counter ``syncs``; ``profiling.timers``). Every SpMV goes through
``device.par.spmv``, so it launches the DIA/BDIA kernels. The JAX
package's ``krylov/_cache.py`` has no counterpart: it caches jitted solver
programs, and this eager port compiles none.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.par import DeviceParCSR, spmv
from raptor_tpu_torch.profiling.timers import solve_span, span, sync_span

# ``DeviceHierarchy.precond_pack()``: z = precond(x0, r), one V-cycle
Precond = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class CGResult(NamedTuple):
    x: torch.Tensor         # [S, R] solution
    res: np.ndarray         # [max_iter+1] relative residual history, padded
    #                         with -1 past convergence
    n_iters: int
    indefinite: bool


def default_max_iter(A: DeviceParCSR) -> int:
    """The reference's default iteration cap, 1.3 n + 2."""
    return int(1.3 * A.global_num_rows) + 2


def cg(A: DeviceParCSR, x0: torch.Tensor, b: torch.Tensor,
       tol: float = 1e-5, max_iter: Optional[int] = None,
       precond: Optional[Precond] = None,
       zero_tol: float = 1e-16) -> CGResult:
    """Global CG solve on stacked [S, R] vectors. ``precond``, if given,
    is ``DeviceHierarchy.precond_pack()``: this is PCG
    (par_cg.cpp:121-239)."""
    if max_iter is None:
        max_iter = default_max_iter(A)

    def dot(u, v):
        return dpar.dot(u, v, A.comm)

    def read(*scalars):
        t = torch.stack(scalars)
        with sync_span():
            return t.tolist()

    with solve_span("raptor.cg"):
        b_norm = torch.sqrt(dot(b, b))
        b_norm = torch.where(b_norm < zero_tol, 1.0, b_norm)

        x = x0
        r = b - spmv(A, x)
        z = r if precond is None else precond(torch.zeros_like(r), r)
        p = z
        rz = dot(r, z)
        norm_r = torch.sqrt(dot(r, r))
        atol = tol * norm_r
        nr, rel, at = read(norm_r, norm_r / b_norm, atol)
        res = np.full(max_iter + 1, -1.0)
        res[0] = rel
        k, indef = 0, False
        while nr > at and k < max_iter and not indef:
            with span("raptor.cg.iter"):
                Ap = spmv(A, p)
                App = dot(Ap, p)
                alpha = rz / App
                x = x + alpha * p
                # true-residual recompute every 8th iteration
                # (par_cg.cpp:75-83)
                r = b - spmv(A, x) if k % 8 == 0 else r - alpha * Ap
                if precond is None:
                    z = r
                    rz_next = dot(r, r)
                    norm_r = torch.sqrt(rz_next)
                else:
                    z = precond(torch.zeros_like(r), r)
                    rz_next = dot(r, z)
                    norm_r = torch.sqrt(dot(r, r))
                beta = rz_next / rz
                p = z + beta * p
                rz = rz_next
                k += 1
                nr, rel, app = read(norm_r, norm_r / b_norm, App)
            res[k] = rel
            indef = indef or app < 0.0
        return CGResult(x, res, k, indef)
