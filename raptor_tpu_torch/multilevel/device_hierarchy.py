"""Device-resident AMG hierarchy and V-cycle solve (copy of
raptor_tpu.multilevel.device_hierarchy: construction, V-cycle, solve and
mixed-precision refinement).

The solve-phase half of ParMultilevel (multilevel/par_multilevel.hpp:
335-540): every level becomes a stacked-shard device plan (matrix,
Chebyshev plan, prolongator P and its transpose; restriction is a forward
SpMV on the packed P^T). The iteration is a Python loop that reads the
residual norm back once per cycle for the convergence test. The dense
coarse solve (par_multilevel.hpp:223-333, :347-369) gathers the coarse
right-hand side of every shard and runs one LU solve.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.par import (
    DeviceParCSR, bdia_tile_share, device_put_matrix, spmv)
from raptor_tpu_torch.device.relax import DeviceRelax, build_relax, chebyshev
from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel

# stagnation guard: STALL_RUN consecutive cycles, each reducing the
# residual by less than a factor STALL_RATIO, stop the solve (typically
# the f32 floor; solve_mixed goes below it)
STALL_RATIO = 0.999
STALL_RUN = 4


@dataclasses.dataclass
class DeviceLevel:
    A: DeviceParCSR
    RX: DeviceRelax
    P: Optional[DeviceParCSR]    # None on the coarsest level
    Pt: Optional[DeviceParCSR]


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    res: np.ndarray       # relative residual history, padded with -1
    n_iters: int
    stalled: bool         # stopped by the stagnation guard, not the tolerance


def _coarse_plumbing(part_c, Rc: int) -> Tuple[np.ndarray, np.ndarray]:
    """``gather_idx`` maps global coarse row -> position in the gathered
    padded [S*Rc] vector; ``coarse_take`` [S, Rc] holds each shard's
    global row range."""
    n_c = part_c.global_num_rows
    S = part_c.n_shards
    gather_idx = np.zeros(n_c, dtype=np.int64)
    coarse_take = np.zeros((S, Rc), dtype=np.int64)
    for s in range(S):
        r0, r1 = int(part_c.row_bounds[s]), int(part_c.row_bounds[s + 1])
        gather_idx[r0:r1] = s * Rc + np.arange(r1 - r0)
        coarse_take[s, :r1 - r0] = np.arange(r0, r1)
    return gather_idx, coarse_take


class DeviceHierarchy:
    """Packs a host hierarchy for the device and runs V-cycles on it.

    ``device`` defaults to CUDA and raises when CUDA is absent;
    ``lane_pad`` defaults to 128 on CUDA (the TPU's padding, which makes
    the TPU's DIA/BDIA/embedding picks) and 1 elsewhere. Operators headed
    for ELL take the transfer format that streams the fewest bytes
    (``device.par``)."""

    def __init__(self, ml: ParMultilevel, dtype=torch.float64,
                 lane_pad: int = None, device="cuda"):
        if ml.relax_type != RelaxType.Chebyshev:
            raise NotImplementedError(
                f"{ml.relax_type}: the port's device smoother is "
                f"Chebyshev; Jacobi/SOR/SSOR/l1 and the multicolour sweeps "
                f"come with a later slice")
        self.device = dpar.resolve_device(device)
        if lane_pad is None:
            lane_pad = 128 if self.device.type == "cuda" else 1
        self.lane_pad = lane_pad
        self.dtype = dtype
        self.num_smooth_sweeps = ml.num_smooth_sweeps
        self.solve_tol = ml.solve_tol
        self.max_iterations = ml.max_iterations

        put = dict(dtype=dtype, lane_pad=lane_pad, need_transpose=False,
                   device=self.device)
        levels: List[DeviceLevel] = []
        for lvl in ml.levels:
            dA = device_put_matrix(lvl.A, **put)
            dP = dPt = None
            if lvl.P is not None:
                # the coarse axis embedded at fine-aligned anchors, so the
                # transfer operators format as DIA/BDIA
                dP = device_put_matrix(lvl.P, embed="cols", **put)
                dPt = device_put_matrix(lvl.P.transpose(), embed="rows",
                                        **put)
            levels.append(DeviceLevel(dA, build_relax(lvl.A, dA), dP, dPt))
        self.levels: Tuple[DeviceLevel, ...] = tuple(levels)

        # dense coarse LU: scipy's 0-based pivots are sequential row swaps,
        # which LAPACK (and torch.linalg.lu_solve) number from 1
        lu, piv = ml.coarse_lu
        self.lu = torch.from_numpy(np.asarray(lu)).to(self.device, dtype)
        self.piv = torch.from_numpy(
            np.asarray(piv, dtype=np.int32) + 1).to(self.device)
        part_c = ml.levels[-1].A.partition
        gather_idx, coarse_take = _coarse_plumbing(
            part_c, self.levels[-1].A.rows_pad)
        self.gather_idx = torch.from_numpy(gather_idx).to(self.device)
        self.coarse_take = torch.from_numpy(coarse_take).to(self.device)

        self.row_bounds = ml.levels[0].A.partition.row_bounds
        self.rows_pad = self.levels[0].A.rows_pad
        self._fine_A = ml.levels[0].A
        self._dA64 = None

    def format_summary(self) -> List[str]:
        """One line per level: its rows and the packed format of A, P and
        P^T ("format/embedding" for the transfer operators), with the share
        of its (plane, row block) tiles that a BDIA operator fills."""
        def fmt(M):
            if M.on_format != "bdia":
                return M.on_format
            return f"bdia({bdia_tile_share(M):.1%})"

        lines = []
        for i, lvl in enumerate(self.levels):
            line = (f"level {i:2d}: {lvl.A.global_num_rows:9d} rows  "
                    f"A {fmt(lvl.A):5s}")
            if lvl.P is not None:
                line += (f"  P {fmt(lvl.P)}/{lvl.P.embed_kind:5s}"
                         f"  Pt {fmt(lvl.Pt)}/{lvl.Pt.embed_kind}")
            lines.append(line)
        return lines

    # --- the cycle --------------------------------------------------------------
    def coarse_solve(self, row_mask: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
        """Gather every shard's coarse rhs and solve densely
        (par_multilevel.hpp:347-369)."""
        bvec = b.reshape(-1)[self.gather_idx]
        y = torch.linalg.lu_solve(self.lu, self.piv, bvec[:, None])[:, 0]
        return y[self.coarse_take] * row_mask

    def vcycle(self, x: torch.Tensor, b: torch.Tensor,
               level: int = 0) -> torch.Tensor:
        """One V-cycle on stacked shard vectors (par_multilevel.hpp:
        335-459)."""
        lvl = self.levels[level]
        if level == len(self.levels) - 1:
            return self.coarse_solve(lvl.A.row_mask, b)
        x = chebyshev(lvl.A, lvl.RX, x, b, self.num_smooth_sweeps)
        r = b - spmv(lvl.A, x)
        bc = spmv(lvl.Pt, r)                     # restriction
        xc = torch.zeros((bc.shape[0], lvl.Pt.rows_pad), dtype=b.dtype,
                         device=b.device)
        xc = self.vcycle(xc, bc, level + 1)
        x = x + spmv(lvl.P, xc)                  # prolongation
        return chebyshev(lvl.A, lvl.RX, x, b, self.num_smooth_sweeps)

    # --- solves ----------------------------------------------------------------
    def solve(self, x: torch.Tensor, b: torch.Tensor) -> SolveResult:
        """Iterated V-cycles to ``solve_tol`` (par_multilevel.hpp:461-540);
        x, b: stacked [S, R] device vectors (see ``vector``)."""
        A0 = self.levels[0].A
        max_iter = self.max_iterations
        b_norm = float(dpar.norm(b))

        def rel_norm(r):
            n = float(dpar.norm(r))
            return n / b_norm if abs(b_norm) > 1e-16 else n

        r_norm = rel_norm(b - spmv(A0, x))
        res = np.full(max_iter + 1, -1.0)
        res[0] = r_norm
        k = run = 0
        while r_norm > self.solve_tol and k < max_iter and run < STALL_RUN:
            x = self.vcycle(x, b)
            new_norm = rel_norm(b - spmv(A0, x))
            run = run + 1 if new_norm > STALL_RATIO * r_norm else 0
            r_norm = new_norm
            k += 1
            res[k] = r_norm
        return SolveResult(x, res, k,
                           run >= STALL_RUN and r_norm > self.solve_tol)

    def solve_mixed(self, x64: np.ndarray, b64: np.ndarray,
                    tol: float = 1e-7, max_iter: int = 100,
                    return_device: bool = False):
        """Iterative refinement: float64 residuals against the fine A with
        this (typically float32) hierarchy's V-cycle as the correction.

        Returns (x, residual history): x as a float64 host vector, or as
        the stacked device tensor when ``return_device``."""
        if self._dA64 is None:
            self._dA64 = device_put_matrix(
                self._fine_A, dtype=torch.float64, lane_pad=self.lane_pad,
                need_transpose=False, device=self.device)
        dA64 = self._dA64

        def vec(v):
            return dpar.device_put_vector(np.asarray(v, np.float64),
                                          self.row_bounds, dA64.rows_pad,
                                          dtype=torch.float64,
                                          device=self.device)

        x, b = vec(x64), vec(b64)
        b_norm = float(dpar.norm(b))
        b_norm = b_norm if b_norm > 1e-300 else 1.0
        r = b - spmv(dA64, x)
        hist = [float(dpar.norm(r)) / b_norm]
        while hist[-1] > tol and len(hist) <= max_iter:
            e = self.vcycle(torch.zeros_like(r, dtype=self.dtype),
                            r.to(self.dtype))
            x = x + e.to(torch.float64)
            r = b - spmv(dA64, x)
            hist.append(float(dpar.norm(r)) / b_norm)
        hist = np.asarray(hist)
        if return_device:
            return x, hist
        return dpar.host_vector(x, self.row_bounds), hist

    # --- vector helpers ---------------------------------------------------------
    def vector(self, v: np.ndarray) -> torch.Tensor:
        return dpar.device_put_vector(v, self.row_bounds, self.rows_pad,
                                      dtype=self.dtype, device=self.device)

    def host(self, v: torch.Tensor) -> np.ndarray:
        return dpar.host_vector(v, self.row_bounds)
