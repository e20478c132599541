"""BiCGStab family: plain, AMG-preconditioned, and the communication-
reducing research variants (copy of raptor_tpu.krylov.bicgstab).

Matches the reference (krylov/par_bicgstab.cpp):
- ``BiCGStab`` :11 — res stores ABSOLUTE ||r||, tol is relative to r0
- ``Pre_BiCGStab`` :240 — right-preconditioned with an AMG cycle on p and s
- ``SeqInner/SeqNorm/SeqInnerSeqNorm_BiCGStab`` :128,:372,:481 — inner
  products/norms computed in a deterministic shard-sequential order
  (krylov/partial_inner.cpp:103 ``sequential_inner``): here the per-shard
  partial dots summed in shard order
- ``PI_BiCGStab``/``PrePI_BiCGStab`` :593,:738 — approximate inner products
  over half the shards, scaled by global_n/part_global
  (partial_inner.cpp:208 ``half_inner``), alternating halves per iteration

Every inner product starts from ``device.par.shard_dots``, the [S] shard
partials in shard order (gathered from every controller across
controllers, so each reduces the same vector): "psum" sums the S
partials, "sequential" sums them in shard order, ``partial`` sums those of
shards ``idx < (S+1)//2`` on even iterations and of the others on odd
ones, scaled by the valid rows of every shard. At S = 1 the odd half is
empty: its inner products are 0, as in the JAX package, and the solve
stops on the non-finite residual that follows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raptor_tpu_torch.device.par import (DeviceParCSR, all_shards,
                                         shard_dots, spmv)
from raptor_tpu_torch.krylov.cg import Precond, default_max_iter


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    res: np.ndarray       # absolute ||r|| history, padded with -1
    n_iters: int


def _inner_fn(A: DeviceParCSR, inner_mode: str, partial: bool):
    """inner(u, v, parity) as the JAX package's shards compute it, on the
    [S] partials of every shard (across controllers too)."""
    n_valid = all_shards(A.row_mask.sum(dim=1), A.comm)   # [S] valid rows
    S = n_valid.shape[0]
    first_half = torch.arange(S, device=A.device) < (S + 1) // 2
    global_n = float(A.global_num_rows)

    def inner(u, v, parity: int):
        parts = shard_dots(u, v, A.comm)
        if partial:
            # half_inner (partial_inner.cpp:208-278)
            in_half = first_half if parity == 0 else ~first_half
            part_global = torch.where(in_half, n_valid, 0.0).sum()
            total = torch.where(in_half, parts, 0.0).sum()
            return total * (global_n / torch.clamp(part_global, min=1))
        if inner_mode == "sequential":
            # sequential_inner (partial_inner.cpp:103-137)
            return torch.cumsum(parts, 0)[-1]
        return parts.sum()
    return inner


def bicgstab(A: DeviceParCSR, x0: torch.Tensor, b: torch.Tensor,
             tol: float = 1e-5, max_iter: Optional[int] = None,
             precond: Optional[Precond] = None, inner_mode: str = "psum",
             norm_mode: str = "psum",
             partial: bool = False) -> BiCGStabResult:
    """``precond`` is ``DeviceHierarchy.precond_pack()``; ``inner_mode``
    and ``norm_mode`` are "psum" or "sequential"."""
    if max_iter is None:
        max_iter = default_max_iter(A)
    inner = _inner_fn(A, inner_mode, partial)
    norm_inner = _inner_fn(A, norm_mode, False)

    def norm2(u):
        return torch.sqrt(norm_inner(u, u, 0))

    def M(v):
        return v if precond is None else precond(torch.zeros_like(v), v)

    x = x0
    r = b - spmv(A, x)
    r_star = r
    p = r
    rr = inner(r, r_star, 0)
    norm_r = norm2(r)
    nr, at = torch.stack([norm_r, tol * norm_r]).tolist()
    res = np.full(max_iter + 1, -1.0)
    res[0] = nr
    k = 0
    while nr > at and k < max_iter:
        parity = k % 2
        p_hat = M(p)
        Ap = spmv(A, p_hat)
        alpha = rr / inner(Ap, r_star, parity)
        s = r - alpha * Ap
        s_hat = M(s)
        As = spmv(A, s_hat)
        omega = inner(As, s, parity) / inner(As, As, parity)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * As
        rr_next = inner(r, r_star, parity)
        beta = (rr_next / rr) * (alpha / omega)
        p = r + beta * (p - omega * Ap)
        rr = rr_next
        k += 1
        nr = norm2(r).item()
        res[k] = nr
    return BiCGStabResult(x, res, k)


# Named variants mirroring the reference API (par_bicgstab.hpp:14-27)
def seq_inner_bicgstab(A, x0, b, **kw):
    return bicgstab(A, x0, b, inner_mode="sequential", **kw)


def seq_norm_bicgstab(A, x0, b, **kw):
    return bicgstab(A, x0, b, norm_mode="sequential", **kw)


def seq_inner_seq_norm_bicgstab(A, x0, b, **kw):
    return bicgstab(A, x0, b, inner_mode="sequential",
                    norm_mode="sequential", **kw)


def pi_bicgstab(A, x0, b, **kw):
    return bicgstab(A, x0, b, partial=True, **kw)


def pre_bicgstab(A, x0, b, precond, **kw):
    return bicgstab(A, x0, b, precond=precond, **kw)


def pre_pi_bicgstab(A, x0, b, precond, **kw):
    return bicgstab(A, x0, b, precond=precond, partial=True, **kw)
