"""Device Chebyshev smoother (copy of raptor_tpu.device.relax: the
diagonal plan, the power-iteration interval and ``chebyshev_shard``).

Hybrid semantics as in the reference's par_relax.cpp: halo values are
exchanged once per SpMV. Jacobi, SOR/SSOR, the multicolour sweeps and
l1-Jacobi come with a later slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import ZERO_TOL
from raptor_tpu_torch.device.formats import off_spmv
from raptor_tpu_torch.device.par import DeviceParCSR, halo_exchange, on_spmv


@dataclasses.dataclass
class DeviceRelax:
    """Per-shard smoother plan, stacked over shards like DeviceParCSR."""

    inv_diag: torch.Tensor  # [S, R] 1 / a_ii (1.0 on padding, missing diag)
    has_diag: torch.Tensor  # [S, R] 1.0 where |diag| > zero_tol
    # Chebyshev interval for D^{-1} A (power-iteration estimate at setup)
    cheb_lo: float
    cheb_hi: float


def _cheb_interval(a: ParCSRMatrix):
    """Power-iteration estimate of lambda_max of D^{-1} A, shard by shard;
    the interval is [0.3, 1.1] * lambda_max, per hypre practice."""
    part = a.partition
    shards = a.shards()
    rng_v = np.random.default_rng(42).random(part.global_num_rows) + 0.1
    v = rng_v / np.linalg.norm(rng_v)
    invd = []
    for blk in shards:
        d = blk.on_proc.diagonal()
        invd.append(np.where(np.abs(d) > ZERO_TOL, d, 1.0))
    lmax = 1.0
    for _ in range(12):
        locs = []
        for s, blk in enumerate(shards):
            c0, c1 = int(part.col_bounds[s]), int(part.col_bounds[s + 1])
            w = blk.on_proc.mult(v[c0:c1])
            if blk.off_proc.nnz:
                w = w + blk.off_proc.mult(v[blk.off_proc_column_map])
            locs.append(w / invd[s])
        w_full = np.concatenate(locs)
        nw = np.linalg.norm(w_full)
        if nw <= 0:
            break
        lmax, v = nw, w_full / nw
    return 0.3 * float(lmax), 1.1 * float(lmax)


def build_relax(a: ParCSRMatrix, dA: DeviceParCSR) -> DeviceRelax:
    """Host construction of the Chebyshev plan, in ``dA``'s dtype and on
    its device."""
    S, R = len(a.shards()), dA.rows_pad
    diag_a = np.ones((S, R))
    has = np.zeros((S, R))
    for s, blk in enumerate(a.shards()):
        diag = blk.on_proc.diagonal()
        n = len(diag)
        diag_a[s, :n] = np.where(np.abs(diag) > ZERO_TOL, diag, 1.0)
        has[s, :n] = np.abs(diag) > ZERO_TOL
    cheb_lo, cheb_hi = _cheb_interval(a)

    def put(x):
        return torch.from_numpy(x).to(dA.device, dA.dtype)

    return DeviceRelax(inv_diag=put(1.0 / diag_a),
                       has_diag=put(has), cheb_lo=cheb_lo, cheb_hi=cheb_hi)


def _ad(A: DeviceParCSR, d: torch.Tensor, dist: torch.Tensor):
    """A d with the halo values already exchanged."""
    return on_spmv(A, d) + off_spmv(A.off_rows, A.off_cols, A.off_vals,
                                    dist, A.rows_pad)


def chebyshev(A: DeviceParCSR, RX: DeviceRelax, x: torch.Tensor,
              b: torch.Tensor, num_sweeps: int) -> torch.Tensor:
    """Chebyshev polynomial smoother of degree ``num_sweeps`` on
    [cheb_lo, cheb_hi] of D^{-1} A: one SpMV per degree."""
    degree = max(1, num_sweeps)
    theta = 0.5 * (RX.cheb_hi + RX.cheb_lo)
    delta = 0.5 * (RX.cheb_hi - RX.cheb_lo)
    sigma = theta / delta

    r = b - _ad(A, x, halo_exchange(A, x))
    z = r * RX.inv_diag * RX.has_diag
    d = z / theta
    x = x + d
    rho = 1.0 / sigma
    for _ in range(1, degree):
        r = r - _ad(A, d, halo_exchange(A, d))
        z = r * RX.inv_diag * RX.has_diag
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x
