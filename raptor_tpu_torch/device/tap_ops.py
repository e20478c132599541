"""Topology-aware SpMVs over stacked (host, local) shards (the names of
raptor_tpu.device.tap_ops): the TAP analog of util/linalg/par_spmv.cpp:
61-89 (``tap_mult``) and :157-209 (``tap_mult_T``).

They are ``device.par.spmv`` / ``spmv_T`` with the plan ``T``
(``comm.tap``): the on_proc block runs the same kernels as the plain
SpMV; only the halo exchange goes through ``T``."""

from __future__ import annotations

import torch

from raptor_tpu_torch.comm.tap import DeviceTAP
from raptor_tpu_torch.device.par import DeviceParCSR, spmv, spmv_T


def tap_spmv(A: DeviceParCSR, T: DeviceTAP, x: torch.Tensor) -> torch.Tensor:
    """b = A x with the halo through ``T``; x [S, C] -> b [S, R]."""
    return spmv(A, x, T)


def tap_spmv_T(A: DeviceParCSR, T: DeviceTAP,
               x: torch.Tensor) -> torch.Tensor:
    """b = A^T x with the halo contributions summed back through ``T``;
    x [S, R] -> b [S, C]."""
    return spmv_T(A, x, T)
