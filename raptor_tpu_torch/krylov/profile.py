"""Krylov per-phase time split (copy of raptor_tpu.krylov.profile): the
reference's ``comm_t`` / ``precond_t`` out-parameters
(krylov/par_cg.cpp:121-239, par_bicgstab.cpp).

The reference brackets its MPI calls and the preconditioner inside the
iteration with wall-clock timers. Here each part of a PCG iteration is
timed on its own, as a chain of back-to-back applications on the
matrix's device, the four chains in turn, one step of each a round,
and each time the median of its steps
(``profiling.timers.interleaved_seconds``: CUDA events around each
application on the card), each result rescaled by 1 / (1 + max |y|)
outside the timed part so that the chain stays finite:

- ``total_t``: one PCG iteration (one SpMV, the alpha / beta recurrences,
  the inner products and, with a preconditioner, one V-cycle);
- ``spmv_t``: one SpMV (halo exchange, on- and off-shard products);
- ``comm_t``: one halo exchange and two inner products;
- ``precond_t``: one ``precond_pack()`` application, 0.0 without one.

All in seconds per iteration. On one card the exchange is a transpose of
the stacked send buffer; with a matrix of one controller (``A.comm``)
every controller calls this together, as it calls the solver.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.par import DeviceParCSR, halo_exchange, spmv
from raptor_tpu_torch.krylov.cg import Precond
from raptor_tpu_torch.profiling.timers import interleaved_seconds, rescale

REPS = 40


def pcg_step(A: DeviceParCSR, precond: Optional[Precond] = None
             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The work of one PCG iteration as a map x -> x': one SpMV, three
    inner products, the alpha / beta updates and, with ``precond``, one
    V-cycle, with x standing in for the search direction and the residual
    (the same kernels as an iteration of ``cg`` that does not recompute
    the true residual, on other values)."""

    def dot(u, v):
        return dpar.dot(u, v, A.comm)

    def step(x):
        ap = spmv(A, x)
        app = dot(ap, x)
        alpha = dot(x, x) / app
        r = x - alpha * ap
        z = r if precond is None else precond(torch.zeros_like(r), r)
        beta = dot(r, z) / app
        return z + beta * x

    return step


def pcg_time_split(A: DeviceParCSR, b: torch.Tensor,
                   precond: Optional[Precond] = None,
                   reps: int = REPS) -> Dict[str, float]:
    """Per-iteration time split of (preconditioned) CG on ``A`` with the
    stacked ``[S, R]`` right-hand side ``b``; ``precond`` is
    ``DeviceHierarchy.precond_pack()``. Returns {"total_t", "spmv_t",
    "comm_t", "precond_t"} in seconds."""

    def dot(u, v):
        return dpar.dot(u, v, A.comm)

    def comm(x):
        # the exchange and the inner products, each result left unused:
        # nothing is fused or elided in eager mode, and x goes on as it is
        halo_exchange(A, x)
        dot(x, x)
        dot(x, x)
        return x

    def apply(x):
        return precond(torch.zeros_like(x), x)

    iteration = pcg_step(A, precond)

    chains = {"total_t": (iteration, b, rescale),
              "spmv_t": (lambda x: spmv(A, x), b, rescale),
              "comm_t": (comm, b, None)}
    if precond is not None:
        chains["precond_t"] = (apply, b, rescale)
    out = interleaved_seconds(chains, reps)
    out.setdefault("precond_t", 0.0)
    return out
