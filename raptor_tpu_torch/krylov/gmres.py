"""Restarted GMRES(m), plain and AMG-preconditioned (copy of
raptor_tpu.krylov.gmres).

The reference library stops at CG/BiCGStab; GMRES follows the
conventions of krylov/cg.py:
- ``res[k] = |g_{j+1}| / ||b||`` (the GMRES residual estimate; exact
  for the minimized residual), ``||b||`` clamped to 1 when ~0
- convergence on ``||r|| <= tol * ||r_0||``
- right preconditioning: the correction is ``M^{-1} (V y)``, so the
  REAL residual ``b - A x`` is minimized (one extra preconditioner
  apply per restart, no Z basis stored)

The Arnoldi basis is one ``[m+1, S, R]`` tensor; orthogonalization is
classical Gram-Schmidt with one reorthogonalization (CGS2), two batched
``V^T w`` products a step. The Hessenberg column comes back to the host
once a step (the loop test needs it there anyway), where the Givens
rotations and the triangular solve run on NumPy scalars of the solve's
dtype, as the JAX package runs them on replicated device scalars. A
restart ends on the true residual and stops when it stagnates. Across
controllers (a matrix with a ``comm``, one shard each) the norms and the
Gram-Schmidt dots sum the per-shard partials gathered into shard order,
so the Hessenberg solve runs on the same numbers, and so identically, on
every controller.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.linalg
import torch

from raptor_tpu_torch.device.par import DeviceParCSR, all_shards, dot, spmv
from raptor_tpu_torch.krylov.cg import Precond, default_max_iter


class GMRESResult(NamedTuple):
    x: torch.Tensor         # [S, R] solution
    res: np.ndarray         # [max_iter+1] relative residuals, -1 padded
    n_iters: int            # total inner iterations


def _batched_dots(V: torch.Tensor, w: torch.Tensor,
                  comm=None) -> torch.Tensor:
    """<V[i], w> for every basis vector: each shard's local dots (gathered
    across controllers into ``[i, S]``), summed over the shards."""
    parts = (V * w).sum(dim=-1)                       # [i, S_local]
    if comm is not None:
        parts = all_shards(parts.T, comm).T.contiguous()
    return parts.sum(dim=-1)


def gmres(A: DeviceParCSR, x0: torch.Tensor, b: torch.Tensor,
          tol: float = 1e-5, restart: int = 30,
          max_iter: Optional[int] = None, precond: Optional[Precond] = None,
          zero_tol: float = 1e-16) -> GMRESResult:
    """Global restarted GMRES(m) solve. ``precond``, if given, is
    ``DeviceHierarchy.precond_pack()``: AMG-preconditioned GMRES. The
    Arnoldi basis costs ``restart + 1`` vectors of device memory."""
    if max_iter is None:
        max_iter = default_max_iter(A)
    m = restart
    dt = torch.empty(0, dtype=b.dtype).numpy().dtype.type
    comm = A.comm

    def norm(v) -> float:
        return dt(torch.sqrt(dot(v, v, comm)).item())

    def apply_M(v):
        return v if precond is None else precond(torch.zeros_like(v), v)

    b_norm = norm(b)
    b_norm = dt(1.0) if b_norm < zero_tol else b_norm
    x = x0
    beta0 = norm(b - spmv(A, x))
    atol = dt(tol) * beta0
    res = np.full(max_iter + 1, -1.0)
    res[0] = beta0 / b_norm
    k, done, prev_beta = 0, bool(beta0 <= atol), beta0
    while k < max_iter and not done:
        r = b - spmv(A, x)
        beta = norm(r)
        V = torch.zeros((m + 1,) + tuple(b.shape), dtype=b.dtype,
                        device=b.device)
        V[0] = r / float(1.0 if beta < zero_tol else beta)
        H = np.zeros((m + 1, m), dtype=dt)
        cs = np.zeros(m, dtype=dt)
        sn = np.zeros(m, dtype=dt)
        g = np.zeros(m + 1, dtype=dt)
        g[0] = beta
        j, done = 0, bool(beta <= atol)
        while j < m and k < max_iter and not done:
            w = spmv(A, apply_M(V[j]))
            Vj = V[:j + 1]
            h = _batched_dots(Vj, w, comm)
            w = w - (h[:, None, None] * Vj).sum(dim=0)
            h2 = _batched_dots(Vj, w, comm)
            w = w - (h2[:, None, None] * Vj).sum(dim=0)
            hj = torch.cat([h + h2, torch.sqrt(dot(w, w, comm))[None]])
            col = np.zeros(m + 1, dtype=dt)
            col[:j + 2] = hj.cpu().numpy()
            hj1 = col[j + 1]
            lucky = bool(hj1 < zero_tol)
            V[j + 1] = w / float(1.0 if lucky else hj1)
            # the previous Givens rotations, then the new one
            for i in range(j):
                t0 = cs[i] * col[i] + sn[i] * col[i + 1]
                t1 = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i], col[i + 1] = t0, t1
            denom = np.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            denom = dt(1.0) if denom < zero_tol else denom
            cj, sj = col[j] / denom, col[j + 1] / denom
            col[j] = cj * col[j] + sj * col[j + 1]
            col[j + 1] = 0.0
            cs[j], sn[j] = cj, sj
            gj = g[j]
            g[j], g[j + 1] = cj * gj, -sj * gj
            H[:, j] = col
            resid = abs(g[j + 1])
            k += 1
            res[k] = resid / b_norm
            done = bool(resid <= atol) or lucky
            j += 1
        # back substitution on the j x j system
        y = (scipy.linalg.solve_triangular(H[:j, :j], g[:j], lower=False)
             if j else np.zeros(0, dtype=dt))
        comb = (torch.from_numpy(y).to(b.device)[:, None, None]
                * V[:j]).sum(dim=0)
        x = x + apply_M(comb)
        # convergence is decided on the TRUE residual: in f32 the |g|
        # estimate drifts optimistic as orthogonality decays, so a restart
        # whose estimate converged but whose real residual did not keeps
        # iterating (one extra SpMV per restart)
        beta_t = norm(b - spmv(A, x))
        # stagnation guard: a restart that improves the true residual by
        # < 0.1% is at the precision floor; stop instead of burning
        # max_iter restarts
        done = bool(beta_t <= atol) or bool(beta_t >= prev_beta * dt(0.999))
        res[k] = beta_t / b_norm
        prev_beta = beta_t
    return GMRESResult(x, res, k)
