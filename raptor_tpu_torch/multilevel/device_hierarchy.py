"""Device-resident AMG hierarchy and V-cycle solve (copy of
raptor_tpu.multilevel.device_hierarchy: construction, V-cycle, solve,
mixed-precision refinement, the preconditioner of the Krylov solvers and
the topology-aware exchange of the ``tap_amg`` levels).

The solve-phase half of ParMultilevel (multilevel/par_multilevel.hpp:
335-540): every level becomes a stacked-shard device plan (matrix,
smoother plan, prolongator P and its transpose; restriction is a forward
SpMV on the packed P^T). The iteration is a Python loop that reads the
residual norm back once per cycle for the convergence test. The dense
coarse solve (par_multilevel.hpp:223-333, :347-369) gathers the coarse
right-hand side of every shard and runs one LU solve. From level
``ml.tap_amg`` down (the reference's knob, par_multilevel.hpp:88; -1 turns
it off) every SpMV and smoother halo of the cycle goes through the
topology-aware exchange (``comm.tap``) of a (host, local) shard layout
(``device.par.make_mesh2``); the mixed-precision residual and the Krylov
operators keep the plain exchange, as in the JAX package.

``DeviceHierarchy.from_spmd`` builds the same device plan from a per-rank
whole-hierarchy setup (``comm.spmd``): it packs each level's local view
through the transport and forms P^T by the distributed transpose, with no
global matrix, and then solves as the in-process route does. Given a
``comm.bootstrap.DeviceComm`` (one controller per shard, the setup over
``comm.multiproc.MultiProcessTransport``), each controller packs and
solves only its shard: the halo exchanges are ``comm.all_to_all`` (on the
``tap_amg`` levels all-to-alls over the comm's host and local sub-groups),
the norms sum the gathered per-shard dots, and the coarse solve gathers
the coarse right-hand side with ``comm.all_gather`` and solves the whole
(replicated) coarse system on every controller, keeping its own rows. The
host vectors such a hierarchy takes and gives hold the controller's rows
only; its ``precond_pack`` serves the Krylov solvers across controllers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.comm.tap import (
    DeviceTAP, build_tap_plan, build_tap_plan_from_maps, device_put_tap)
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import RelaxType
from raptor_tpu_torch.device import par as dpar
from raptor_tpu_torch.device.par import (
    DeviceParCSR, bdia_tile_share, device_put_matrix, spmv)
from raptor_tpu_torch.device.relax import RELAX_FNS, DeviceRelax, build_relax
from raptor_tpu_torch.multilevel.par_multilevel import ParMultilevel
from raptor_tpu_torch.profiling.timers import (
    Profiler, count, interleaved_seconds, rescale, solve_span, span,
    sync_span)
from raptor_tpu_torch.ruge_stuben import par_setup as ps

RELAX_NAME = {RelaxType.Jacobi: "jacobi", RelaxType.SOR: "sor",
              RelaxType.SSOR: "ssor", RelaxType.MCSOR: "mc_sor",
              RelaxType.MCSSOR: "mc_ssor", RelaxType.L1Jacobi: "l1_jacobi",
              RelaxType.Chebyshev: "chebyshev"}
# the heavy plans each smoother reads (device.relax.build_relax)
RELAX_NEED = {"jacobi": ("tri",), "sor": ("tri",), "ssor": ("tri",),
              "mc_sor": ("color",), "mc_ssor": ("color",),
              "l1_jacobi": (), "chebyshev": ()}

# the spans of the solves and of the cycle's steps (profiling.timers); a
# step's level is that of the ``DeviceLevel.span`` it lies in
RESIDUAL = "raptor.refine.residual"     # solve_mixed's float64 residual
PRE, POST = "raptor.relax.pre", "raptor.relax.post"
CYCLE_RESIDUAL = "raptor.residual"
RESTRICT, PROLONG = "raptor.restrict", "raptor.prolong"
COARSE = "raptor.coarse_solve"


def host_scalar(t: torch.Tensor) -> float:
    """A device scalar read on the host (``profiling.timers.sync_span``)."""
    with sync_span():
        return float(t)


@dataclasses.dataclass
class DeviceLevel:
    A: DeviceParCSR
    RX: DeviceRelax
    P: Optional[DeviceParCSR]    # None on the coarsest level
    Pt: Optional[DeviceParCSR]
    # topology-aware exchange plans of A, P and P^T (None unless
    # 0 <= tap_amg <= level)
    TA: Optional[DeviceTAP] = None
    TP: Optional[DeviceTAP] = None
    TPt: Optional[DeviceTAP] = None
    # the name of the level's V-cycle span, raptor.vcycle.L<level>, built
    # once when the level is packed
    span: Optional[str] = None


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    res: np.ndarray       # relative residual history, padded with -1
    n_iters: int
    stalled: bool         # stopped by the stagnation guard, not the tolerance


def format_times(rows: List[dict]) -> str:
    """``DeviceHierarchy.profile_cycle``'s rows as a table in ms, one line a
    level (``print_times``)."""
    out = [f"{'lvl':>3} {'relax(ms)':>10} {'spmv(ms)':>9} "
           f"{'P^T..P(ms)':>11}"]
    for r in rows:
        out.append(f"{r['level']:>3} {r['relax_s'] * 1e3:>10.3f} "
                   f"{r['spmv_s'] * 1e3:>9.3f} "
                   f"{r['transfer_s'] * 1e3:>11.3f}")
    return "\n".join(out)


def _coarse_plumbing(part_c, Rc: int, first_shard: int,
                     SL: int) -> Tuple[np.ndarray, np.ndarray]:
    """Redundant-coarse index plumbing shared by the in-process and SPMD
    constructions (they must stay bit-identical): ``gather_idx`` maps
    global coarse row -> position in the gathered padded [S*Rc] vector;
    ``coarse_take`` [SL, Rc] holds each LOCAL shard's global row range,
    from ``first_shard`` on (in-process: 0 and every shard)."""
    n_c = part_c.global_num_rows
    gather_idx = np.zeros(n_c, dtype=np.int64)
    for s in range(part_c.n_shards):
        r0, r1 = int(part_c.row_bounds[s]), int(part_c.row_bounds[s + 1])
        gather_idx[r0:r1] = s * Rc + np.arange(r1 - r0)
    coarse_take = np.zeros((SL, Rc), dtype=np.int64)
    for i in range(SL):
        s = first_shard + i
        r0, r1 = int(part_c.row_bounds[s]), int(part_c.row_bounds[s + 1])
        coarse_take[i, :r1 - r0] = np.arange(r0, r1)
    return gather_idx, coarse_take


class DeviceHierarchy:
    """Packs a host hierarchy for the device and runs V-cycles on it.

    ``device`` defaults to CUDA and raises when CUDA is absent;
    ``lane_pad`` defaults to 128 on CUDA (the TPU's padding, which makes
    the TPU's DIA/BDIA/embedding picks) and 1 elsewhere. Operators headed
    for ELL take the transfer format that streams the fewest bytes
    (``device.par``). ``mesh`` is the (host, local) layout
    (``device.par.make_mesh2``) that ``ml.tap_amg >= 0`` needs."""

    def __init__(self, ml: ParMultilevel, dtype=torch.float64,
                 lane_pad: int = None, device="cuda", mesh=None):
        self._set_knobs(device, mesh, ml.levels[0].A.n_shards, ml.tap_amg,
                        lane_pad, dtype, ml.relax_type, ml.num_smooth_sweeps,
                        ml.relax_weight, ml.solve_tol, ml.max_iterations)
        lane_pad = self.lane_pad

        put = dict(dtype=dtype, lane_pad=lane_pad, need_transpose=False,
                   device=self.device)

        def tap(m):
            return device_put_tap(build_tap_plan(m, *mesh.shape), dtype,
                                  self.device)

        levels: List[DeviceLevel] = []
        self.pack_level_times = [{} for _ in ml.levels]
        for i, lvl in enumerate(ml.levels):
            tap_level = 0 <= self.tap_amg <= i
            with self._packing(i, "format"):
                dA = device_put_matrix(lvl.A, **put)
                dP = dPt = TP = TPt = None
                if lvl.P is not None:
                    # the coarse axis embedded at fine-aligned anchors, so
                    # the transfer operators format as DIA/BDIA
                    pt = lvl.P.transpose()
                    dP = device_put_matrix(lvl.P, embed="cols", **put)
                    dPt = device_put_matrix(pt, embed="rows", **put)
                    if tap_level:
                        TP, TPt = tap(lvl.P), tap(pt)
                TA = tap(lvl.A) if tap_level else None
            with self._packing(i, "relax"):
                dRX = build_relax(lvl.A, dA,
                                  need=RELAX_NEED[self.relax_kind])
            levels.append(DeviceLevel(dA, dRX, dP, dPt, TA, TP, TPt,
                                      f"raptor.vcycle.L{i}"))
        self.levels: Tuple[DeviceLevel, ...] = tuple(levels)

        # dense coarse LU: scipy's 0-based pivots are sequential row swaps,
        # which LAPACK (and torch.linalg.lu_solve) number from 1
        with self._packing(len(levels) - 1, "coarse_lu"):
            lu, piv = ml.coarse_lu
            self.lu = torch.from_numpy(np.asarray(lu)).to(self.device, dtype)
            self.piv = torch.from_numpy(
                np.asarray(piv, dtype=np.int32) + 1).to(self.device)
            part_c = ml.levels[-1].A.partition
            gather_idx, coarse_take = _coarse_plumbing(
                part_c, self.levels[-1].A.rows_pad, 0, part_c.n_shards)
            self.gather_idx = torch.from_numpy(gather_idx).to(self.device)
            self.coarse_take = torch.from_numpy(coarse_take).to(self.device)

        self.row_bounds = ml.levels[0].A.partition.row_bounds
        self.rows_pad = self.levels[0].A.rows_pad
        self._fine_A = ml.levels[0].A
        self.first_shard = 0
        self._tr_factory = None

    def _set_knobs(self, device, mesh, n_shards, tap_amg, lane_pad, dtype,
                   relax_type, sweeps, weight, solve_tol, max_iterations,
                   comm=None):
        """The solve's knobs, shared by both constructions: the device,
        the (host, local) layout that ``tap_amg >= 0`` needs, the lane
        padding (128 on CUDA, 1 elsewhere by default), the smoother and
        the controllers' ``comm`` (None: every shard on one device), whose
        count the layout must match too."""
        self.device = dpar.resolve_device(device)
        self.comm = comm
        self.tap_amg = tap_amg
        if tap_amg >= 0 and not (
                isinstance(mesh, dpar.Mesh2) and mesh.n_shards == n_shards
                and (comm is None or comm.world == n_shards)):
            raise ValueError(
                f"tap_amg = {tap_amg} needs mesh=make_mesh2(H, L) with "
                f"H * L = {n_shards} shards"
                + ("" if comm is None else
                   f" on {comm.world} controllers") + f", not {mesh!r}")
        self.mesh = mesh
        if lane_pad is None:
            lane_pad = 128 if self.device.type == "cuda" else 1
        self.lane_pad = lane_pad
        self.dtype = dtype
        self.relax_kind = RELAX_NAME[relax_type]
        self.num_smooth_sweeps = sweeps
        self.relax_weight = weight
        self.solve_tol = solve_tol
        self.max_iterations = max_iterations
        # stagnation guard of ``solve``: stall_run consecutive cycles, each
        # reducing the residual by less than a factor stall_ratio, stop it
        # (typically at the f32 floor; solve_mixed goes below it);
        # stall_run <= 0 turns the guard off
        self.stall_ratio = 0.999
        self.stall_run = 4
        self._dA64 = None
        self._precond = None
        # host seconds of the packing (always on, as ``ml.setup_times``):
        # "format" (the host side of device_put_matrix: comm plan, format
        # choice, layout arrays, embeddings; the P^T transpose), "relax"
        # (build_relax, its Chebyshev bounds), "coarse_lu", and "copy"
        # (the host-to-card copies), nested in the first two and left out
        # of their ``own``; the split of each level is in
        # ``pack_level_times``, the float64 fine operator of solve_mixed in
        # level 0's
        self.pack_times = Profiler("raptor.pack.")
        self.pack_level_times: List[dict] = []

    @contextlib.contextmanager
    def _packing(self, level: int, phase: str):
        """Pack phase ``phase`` of level ``level``: the seconds each phase
        gains in the block are added to the level's split."""
        before = dict(self.pack_times.times)
        with self.pack_times.phase(phase):
            yield
        split = self.pack_level_times[level]
        for k, v in self.pack_times.times.items():
            if v > before.get(k, 0.0):
                split[k] = split.get(k, 0.0) + v - before.get(k, 0.0)

    # --- SPMD bridge: per-rank hierarchy -> device solve ---------------------
    @classmethod
    def from_spmd(cls, hier, make_transport, *, relax_type=None,
                  num_smooth_sweeps: int = 1, relax_weight: float = 1.0,
                  solve_tol: float = 1e-7, max_iterations: int = 100,
                  dtype=torch.float64, lane_pad: int = None,
                  device="cuda", mesh=None, tap_amg: int = -1,
                  comm=None) -> "DeviceHierarchy":
        """The device plan of a per-rank ``comm.spmd.SpmdHierarchy``: each
        level's local view packed through ``make_transport(matrix)`` (pads
        and formats agreed over the transport, the halo plan from the
        rank-local handshake), P^T from the distributed transpose, the
        redundant coarse LU as the setup factored it. The knobs are those
        the in-process route reads from the setup (``relax_type``
        defaults to Chebyshev); ``lane_pad``, ``device`` and ``mesh`` as
        in the constructor, with ``tap_amg >= 0`` on ``mesh``'s layout.
        The views hold every shard (``comm=None``, one device), or this
        controller's one shard, with ``comm`` its ``DeviceComm`` and
        ``make_transport`` a transport across the controllers (module
        docstring)."""
        self = cls.__new__(cls)
        self._set_knobs(device, mesh, hier.levels[0].a_local.n_shards,
                        tap_amg, lane_pad, dtype,
                        relax_type or RelaxType.Chebyshev, num_smooth_sweeps,
                        relax_weight, solve_tol, max_iterations, comm)
        lane_pad = self.lane_pad
        self._tr_factory = make_transport
        self._fine_A = hier.levels[0].a_local
        self.first_shard = self._fine_A.first_shard
        if comm is None and len(self._fine_A.shards()) != \
                self._fine_A.n_shards:
            raise ValueError(
                f"from_spmd: a view of {len(self._fine_A.shards())} of "
                f"{self._fine_A.n_shards} shards exchanges across "
                f"controllers: pass their comm (comm.bootstrap.init)")

        def put(m, tr, **kw):
            return device_put_matrix(m, dtype=dtype, lane_pad=lane_pad,
                                     need_transpose=False,
                                     device=self.device, tr=tr, comm=comm,
                                     **kw)

        def tap_put(m, tr):
            """TAP plan of a local view: every rank's halo column maps,
            allgathered, give the same global plan everywhere."""
            flat = [np.asarray(c) for rank_maps in tr.allgather_obj(
                [blk.off_proc_column_map for blk in m.shards()])
                for c in rank_maps]
            plan = build_tap_plan_from_maps(flat, m.partition, *mesh.shape)
            return device_put_tap(plan, dtype, self.device,
                                  first_shard=m.first_shard,
                                  n_local=len(m.shards()), comm=comm)

        levels: List[DeviceLevel] = []
        self.pack_level_times = [{} for _ in hier.levels]
        for i, lvl in enumerate(hier.levels):
            a = lvl.a_local
            tap_level = 0 <= tap_amg <= i
            with self._packing(i, "format"):
                tr = make_transport(a)
                dA = put(a, tr)
                dP = dPt = TP = TPt = None
                if lvl.p_blocks is not None:
                    part = a.partition
                    cb = hier.levels[i + 1].a_local.partition.row_bounds
                    part_p = Partition(part.global_num_rows, int(cb[-1]),
                                       part.n_shards, part.row_bounds, cb)
                    p_par = ParCSRMatrix.from_local_rows(
                        lvl.p_blocks, part_p, first_shard=a.first_shard)
                    tr_p = make_transport(p_par)
                    pt_par = ParCSRMatrix.from_local_rows(
                        ps.dist_transpose(p_par, tr=tr_p, assemble=False),
                        part_p.transpose(), first_shard=a.first_shard)
                    tr_pt = make_transport(pt_par)
                    dP = put(p_par, tr_p, embed="cols")
                    dPt = put(pt_par, tr_pt, embed="rows")
                    if tap_level:
                        TP = tap_put(p_par, tr_p)
                        TPt = tap_put(pt_par, tr_pt)
            with self._packing(i, "relax"):
                dRX = build_relax(a, dA, need=RELAX_NEED[self.relax_kind],
                                  tr=tr)
            with self._packing(i, "format"):
                TA = tap_put(a, tr) if tap_level else None
            levels.append(DeviceLevel(dA, dRX, dP, dPt, TA, TP, TPt,
                                      f"raptor.vcycle.L{i}"))
        self.levels = tuple(levels)

        with self._packing(len(levels) - 1, "coarse_lu"):
            lu, piv = hier.coarse_lu
            self.lu = dpar.put_replicated(np.asarray(lu), self.device, dtype)
            self.piv = dpar.put_replicated(
                np.asarray(piv, dtype=np.int32) + 1, self.device)
            a_c = hier.levels[-1].a_local
            part_c = a_c.partition
            gather_idx, coarse_take = _coarse_plumbing(
                part_c, self.levels[-1].A.rows_pad, a_c.first_shard,
                len(a_c.shards()))
            self.gather_idx = torch.from_numpy(gather_idx).to(self.device)
            self.coarse_take = dpar.put_stacked(
                {"coarse_take": coarse_take}, part_c.n_shards, self.device,
                first_shard=a_c.first_shard)["coarse_take"]

        self.row_bounds = self._fine_A.partition.row_bounds
        self.rows_pad = self.levels[0].A.rows_pad
        return self

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
    def relax(self, lvl: DeviceLevel, x: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
        """The hierarchy's smoother on one level (its halo through the
        level's TAP plan when it has one)."""
        return RELAX_FNS[self.relax_kind](lvl.A, lvl.RX, x, b,
                                          self.num_smooth_sweeps,
                                          self.relax_weight, lvl.TA)

    def coarse_solve(self, row_mask: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
        """Gather every shard's coarse rhs and solve densely
        (par_multilevel.hpp:347-369); across controllers each gathers
        every controller's rows, solves the whole system and keeps its
        own."""
        if self.comm is not None:
            b = self.comm.all_gather(b[0])          # [S, Rc]
        bvec = b.reshape(-1)[self.gather_idx]
        y = torch.linalg.lu_solve(self.lu, self.piv, bvec[:, None])[:, 0]
        return y[self.coarse_take] * row_mask

    def vcycle(self, x: torch.Tensor, b: torch.Tensor,
               level: int = 0) -> torch.Tensor:
        """One V-cycle on stacked shard vectors (par_multilevel.hpp:
        335-459)."""
        lvl = self.levels[level]
        if level == 0:
            count("cycles")
        with span(lvl.span):
            if level == len(self.levels) - 1:
                with span(COARSE):
                    return self.coarse_solve(lvl.A.row_mask, b)
            with span(PRE):
                x = self.relax(lvl, x, b)
            with span(CYCLE_RESIDUAL):
                r = b - spmv(lvl.A, x, lvl.TA)
            with span(RESTRICT):
                bc = spmv(lvl.Pt, r, lvl.TPt)
                xc = torch.zeros((bc.shape[0], lvl.Pt.rows_pad),
                                 dtype=b.dtype, device=b.device)
            xc = self.vcycle(xc, bc, level + 1)
            with span(PROLONG):
                x = x + spmv(lvl.P, xc, lvl.TP)
            with span(POST):
                return self.relax(lvl, x, b)

    # --- solves ----------------------------------------------------------------
    def solve(self, x: torch.Tensor, b: torch.Tensor) -> SolveResult:
        """Iterated V-cycles to ``solve_tol`` (par_multilevel.hpp:461-540);
        x, b: stacked [S, R] device vectors (see ``vector``)."""
        with solve_span("raptor.solve"):
            A0, T0 = self.levels[0].A, self.levels[0].TA
            max_iter = self.max_iterations
            b_norm = host_scalar(dpar.norm(b, self.comm))

            def rel_norm(x):
                with span(CYCLE_RESIDUAL):
                    r = b - spmv(A0, x, T0)
                n = host_scalar(dpar.norm(r, self.comm))
                return n / b_norm if abs(b_norm) > 1e-16 else n

            stall_ratio = float(self.stall_ratio)
            stall_run = int(self.stall_run)
            if stall_run <= 0:
                stall_run = max_iter + 1        # never trips

            r_norm = rel_norm(x)
            res = np.full(max_iter + 1, -1.0)
            res[0] = r_norm
            k = run = 0
            while (r_norm > self.solve_tol and k < max_iter
                   and run < stall_run):
                x = self.vcycle(x, b)
                new_norm = rel_norm(x)
                run = run + 1 if new_norm > stall_ratio * r_norm else 0
                r_norm = new_norm
                k += 1
                res[k] = r_norm
            return SolveResult(x, res, k,
                               run >= stall_run and r_norm > self.solve_tol)

    def solve_mixed(self, x64: np.ndarray, b64: np.ndarray,
                    tol: float = 1e-7, max_iter: int = 100,
                    return_device: bool = False):
        """Iterative refinement: float64 residuals against the fine A with
        this (typically float32) hierarchy's V-cycle as the correction.
        ``x64`` and ``b64`` are host vectors (this controller's rows across
        controllers).

        Returns (x, residual history): x as a float64 host vector, or as
        the stacked device tensor when ``return_device``."""
        with solve_span("raptor.solve_mixed"):
            if self._dA64 is None:
                a = self._fine_A
                with self._packing(0, "format"):
                    self._dA64 = device_put_matrix(
                        a, dtype=torch.float64, lane_pad=self.lane_pad,
                        need_transpose=False, device=self.device,
                        tr=self._tr_factory(a) if self._tr_factory
                        else None, comm=self.comm)
            dA64 = self._dA64

            def vec(v):
                return self._put(np.asarray(v, np.float64), dA64.rows_pad,
                                 torch.float64)

            x, b = vec(x64), vec(b64)
            b_norm = host_scalar(dpar.norm(b, self.comm))
            b_norm = b_norm if b_norm > 1e-300 else 1.0
            with span(RESIDUAL):
                r = b - spmv(dA64, x)
            hist = [host_scalar(dpar.norm(r, self.comm)) / b_norm]
            while hist[-1] > tol and len(hist) <= max_iter:
                e = self.vcycle(torch.zeros_like(r, dtype=self.dtype),
                                r.to(self.dtype))
                x = x + e.to(torch.float64)
                with span(RESIDUAL):
                    r = b - spmv(dA64, x)
                hist.append(host_scalar(dpar.norm(r, self.comm)) / b_norm)
            hist = np.asarray(hist)
            if return_device:
                return x, hist
            return self.host(x), hist

    # --- per-level timing (track_times, par_multilevel.hpp:127-205) --------
    def profile_cycle(self, reps: int = 50) -> List[dict]:
        """Seconds of one application of each V-cycle building block, level
        by level: the smoother (all its sweeps), the SpMV and the
        restrict + prolong round trip P (P^T x), with the level's TAP plans
        where the cycle uses them; ``transfer_s`` is 0 on the coarsest
        level. The rows are the JAX package's (``{"level", "relax_s",
        "spmv_s", "transfer_s"}``). Each block is a chain of ``reps``
        applications after a warm-up, every result rescaled by
        1 / (1 + max |y|) per shard so that the chain stays finite; only
        the block is timed, not the rescale, and every level's chains run
        in turn, one step of each a round; each time is the median of its
        ``reps`` (``profiling.timers.interleaved_seconds``: CUDA events
        around each application and one synchronize at the end on the
        card, so a block whose enqueue outlasts its kernels counts its
        enqueue, as in a cycle; the host clock on the CPU). The hierarchy
        is left as it was.

        Across controllers every controller calls it together: each has
        the same chains in the same order (every level's, and no
        ``transfer_s`` chain on the coarsest level on any), so each step's
        halo exchanges meet their partners; the rescale stays on the
        controller's own shard and adds no collective. Each controller
        gets its own shard's rows."""
        chains = {}
        for li, lvl in enumerate(self.levels):
            b = lvl.A.row_mask.to(self.dtype)
            chains[li, "relax_s"] = (
                lambda x, lvl=lvl, b=b: self.relax(lvl, x, b),
                torch.zeros_like(b), rescale)
            chains[li, "spmv_s"] = (
                lambda x, lvl=lvl: spmv(lvl.A, x, lvl.TA), b, rescale)
            if lvl.P is not None:
                chains[li, "transfer_s"] = (
                    lambda x, lvl=lvl: spmv(lvl.P, spmv(lvl.Pt, x, lvl.TPt),
                                            lvl.TP), b, rescale)
        rows = [{"level": li, "relax_s": 0.0, "spmv_s": 0.0,
                 "transfer_s": 0.0} for li in range(len(self.levels))]
        for (li, key), t in interleaved_seconds(chains, reps).items():
            rows[li][key] = t
        return rows

    def print_times(self, reps: int = 20) -> str:
        """``profile_cycle``'s rows as the JAX package's table (print_times,
        par_multilevel.hpp:580-612)."""
        return format_times(self.profile_cycle(reps))

    # --- use as a Krylov preconditioner ----------------------------------------
    def precond_pack(self):
        """One V-cycle as the preconditioner ``precond(x0, r)`` of the
        Krylov solvers (PCG par_cg.cpp:121, Pre_BiCGStab
        par_bicgstab.cpp:240), cached on the hierarchy. The cycle runs in
        the hierarchy's dtype and the correction is cast back to
        ``r.dtype``, so a float64 Krylov loop can use a float32
        hierarchy. Across controllers every controller calls it on its
        shard, as it calls the solver."""
        if self._precond is None:
            def precond(x0: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
                return self.vcycle(x0.to(self.dtype),
                                   r.to(self.dtype)).to(r.dtype)
            self._precond = precond
        return self._precond

    # --- vector helpers ---------------------------------------------------------
    def _put(self, v: np.ndarray, pad: int, dtype) -> torch.Tensor:
        with span("raptor.put"):
            return dpar.device_put_vector(
                v, self.row_bounds, pad, dtype=dtype, device=self.device,
                first_shard=self.first_shard,
                n_local=self.levels[0].A.n_shards)

    def vector(self, v: np.ndarray) -> torch.Tensor:
        """A host vector on the fine level's shards: every row, or this
        controller's rows across controllers."""
        return self._put(v, self.rows_pad, self.dtype)

    def vector_local(self, x_locals) -> torch.Tensor:
        """Fine-level placement from this rank's shard slices (the SPMD
        twin of ``vector``)."""
        return dpar.device_put_vector_local(
            x_locals, self.row_bounds, self.rows_pad, dtype=self.dtype,
            device=self.device, first_shard=self.first_shard)

    def host(self, v: torch.Tensor) -> np.ndarray:
        """The rows of a fine-level vector this device holds (every row,
        or this controller's): a blocking read, as the span
        ``raptor.host`` and one of the counter ``syncs``."""
        with span("raptor.host"):
            count("syncs")
            return dpar.host_vector(v, self.row_bounds, self.first_shard)
