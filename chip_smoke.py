#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raptor_tpu_torch) through its main path
on one NVIDIA card, and check what comes out.

    python3 chip_smoke.py [--n 2048] [--n3 128] [--card-n3 80] [--nk 128]
                          [--sa 128 64] [--bsr 1024 512] [--seed 0]
                          [--phases 3-5,21]

Phases, each printed as it ends; any failure ends the run with a non-zero
exit code and no result line. ``--phases`` runs a selection (numbers and
ranges, comma-separated; all by default): phases 1 and 2 always run, and
a phase brings the phases whose objects it uses (``NEEDS``). The kernel
line then lists every kernel with what the selection measured, null where
no phase of it checked the kernel:

1. card: its name and power limit;
2. build: the host setup library (csrc/setup_kernels.cpp) and the CUDA
   kernels (raptor_tpu_torch/csrc/*.cu), all compilers started together;
3. setup: n x n rotated anisotropic diffusion, Ruge-Stuben + modified
   classical interpolation, theta 0.25, Chebyshev(3), on the host; then the
   float32 device hierarchy, with each operator's format (all DIA/BDIA),
   the value ``pin_arena`` returns (the setup keeps its large buffers in
   the heap arena) and the process's peak RSS (also after phase 6);
4. kernels: the DIA and BDIA kernels against their plain PyTorch versions
   on the real packed operators, in float32 and float64, and their times
   beside the byte bound and a torch.sparse CSR product of the operator;
5. solve: mixed-precision refinement to 1e-8 relative residual, with the
   kernel launch counts of that run, the residual recomputed on the host,
   per-level V-cycle times, and a small problem solved on the card and with
   the plain versions on the CPU, which must agree;
6. 3-D setup: n3^3 27-point Laplacian, PMIS + extended+i (filtered at 0.3),
   theta 0.25, Chebyshev(2); the float32 device hierarchy and the format
   of every level's A, P and P^T;
7. 3-D solve: mixed-precision refinement to 1e-8 with b = A 1 in at most 20
   refinements, with its launch counts, then a random x_true, the V-cycle
   and per-level times and the device busy share;
8. transfer formats: level-0 P and P^T packed in the automatic and in
   each forced format, each applied once and checked against the host
   product (the launch counts of this path), then timed beside its byte
   bound and torch.sparse, with the host seconds of slicing a windowed-ELL
   operator (``formats.well_slices``) beside its pack seconds;
9. 3-D kernels: every kernel of a format the 3-D hierarchy picked (BDIA
   on its largest operator and on A1, windowed ELL on each operator that
   took it), and the windowed-ELL, sorted-scatter and BELL kernels on the
   forced level-0 P and P^T, against their plain versions in float32 and
   float64; for windowed ELL also its sliced layout (slots, fill, column
   width, the x sectors its gathers touch by a host model) and the padded
   bound;
10. 2-D SOR and Krylov: nk x nk rotated anisotropic diffusion, CLJP +
   modified classical, theta 0.25 (the reference's examples/example.py and
   examples/benchmark_pcg.py). The example run: SOR(1), weight 1, a
   float64 hierarchy, b = A 1, solved to 1e-7 (at 128^2, 256^2 or 512^2,
   in at most the JAX package's 23, 29 or 36 V-cycles), with
   the launches, device time, enqueue time and profiler busy time of one
   cycle and each level's forward and backward schedule levels, and a
   small SOR solve on the card and on the CPU, which must agree. Then
   SSOR, Jacobi, l1-Jacobi and multicolour SOR / SSOR, one solve each of
   at most 10 cycles, which must stay finite. Then the Krylov benchmark on
   the same setup with Chebyshev(3) in float32: AMG-PCG, Pre-BiCGStab and
   AMG-preconditioned GMRES(30) to 1e-5, plain CG and BiCGStab to 1e-5 on
   the float64 operator, and a float64 CG with the float32 V-cycle as its
   preconditioner to 1e-11; each must reach its tolerance within its cap.
   Plain CG in float32 is run and printed, not held to 1e-5;
11. smoothed aggregation, at each side of ``--sa`` (bench.py:bench_sa's
   configuration): the 27-point Laplacian, symmetric strength with theta
   0, MIS(2) aggregation, one candidate, Jacobi prolongation (weight 4/3,
   one step), Chebyshev(2), set up on the host with its phase split
   (``print_setup_times``), packed in float32 with every level's format,
   and solved by mixed-precision refinement to 1e-8 with b = A 1. At 128^3
   and 64^3 the level sizes must be the JAX package's and the refinements
   at most its count + 1 (the sorted scatter's float32 atomics sum in an
   order that varies). Then one V-cycle's device, enqueue and busy time,
   per-level times and launches, and the kernels of SA's own operators
   against their plain versions: windowed ELL on the 128^3 P0 and P^T0,
   BDIA on the 128^3 A1 and P1, the sorted scatter on the 64^3 P^T0;
12. blocked AMG, at ``--bsr`` and at 128 x 64 elements (bench.py:bench_bsr:
   Q1 elasticity, the blocked V-cycle to 1e-6 and BSR-PCG to 1e-10);
13. setup on the card: phase 6's configuration at card_n3^3, phase 3's
   at (n/2)^2 and phase 11's at its second side, set up with the default
   engines ("auto" on the card: the device Galerkin product and
   interpolation on every level of at least 2,000,000 nonzeros; phases 3,
   6, 10 and 11 pin the host engines, as the JAX package's counts they are
   held to were taken with them). For each: the engine of every level,
   which must be the device's at or above the gate, the phase split and
   seconds beside the host-engine setup's, a per-level replay (the host
   engine on the same A, S and CF states, or A and P, equal in pattern and
   within 1e-12 of max |host|, with both engines' seconds) and the float32
   solve with b = A 1 (RS in at most 20 refinements, SA in at most the JAX
   package's count + 2). Level 0 of the 3-D setup is multiplied once more,
   under the profiler: bytes-equal to the first product;
14. the topology-aware (TAP) halo exchange and the distributed setup, on
   8 shards laid out as 2 hosts x 4 (the JAX package's multichip record),
   HMIS + extended+i, theta 0.25, host engines. (a) examples/
   benchmark_tap_amg.py at its 512^2: the global setup (the JAX
   package's level sizes), SOR(1) V-cycles in float32 with b = A 1
   refined to 1e-6 (float64 residuals) with the plain exchange, TAP on
   every level and TAP from level 1 (the same V-cycles to within one,
   DIA and BDIA launched), the spread of the TAP
   solutions from the plain one, one V-cycle's device / enqueue / busy ms
   and launches of each exchange, and per level the values the TAP plans
   of A, P and P^T send across hosts beside the plain exchange's (never
   more). (b) the flagship at (n/4)^2 with setup_mode = "distributed"
   (the JAX package's level sizes), its phase split beside the global
   setup's of the same problem, Chebyshev(3) in float32 with TAP on every
   level refined to 1e-8 with b = A 1 in at most 20 refinements, as many
   as with the plain exchange. (c) one float64 TAP V-cycle of a 64^2
   distributed hierarchy on the card and on the CPU: equal to 1e-12 of
   max |x|;
15. the distributed smoothed-aggregation and blocked setups and the SPMD
   bridge (``comm.spmd``, ``DeviceHierarchy.from_spmd``), shards stacked on
   the card, host engines. (a) 14b's problem through ``spmd_rs_setup``
   (its level sizes, its operators and P within 1e-12) packed by
   ``from_spmd`` with the plain exchange and with TAP on every level: 14b's
   refinements to 1e-8 with b = A 1, DIA and BDIA launched, ``vector_local``
   equal to ``vector``, the setup seconds beside 14b's, one V-cycle's
   device / enqueue / busy ms and launches. (b) phase 11's smoothed
   aggregation at 64^3 on 8 shards: ``setup_mode = "distributed"`` (the
   JAX package's distributed level sizes), ``spmd_sa_setup`` equal to it
   level by level, ``from_spmd`` refined to 1e-8 in at most the JAX
   package's refinements + 1. (c) blocked AMG at 128 x 64 elements on 4
   shards, CLJP + modified classical: ``setup_mode = "distributed"`` (the
   JAX package's level sizes, at most its blocked V-cycles to 1e-6 and
   BSR-PCG iterations to 1e-10), ``spmd_bsr_setup`` equal to it level by
   level after a common 1e-14 drop. (d) one float64 V-cycle of a 64^2
   ``from_spmd`` hierarchy on the card and on the CPU: equal to 1e-12 of
   max |x|. (a) also takes the plain hierarchy's ``profile_cycle`` rows,
   which phase 16 prints beside its controllers'. Its seconds and a JSON
   summary line (``phase15``) come before the kernel list;
16. the setup over real OS processes and the device solve with one
   controller per shard (``comm.launch.run_controllers``: 8 interpreters
   on the one card, each ``comm.bootstrap.init`` with gloo, whose
   collectives go through the host). (a) 15a's problem: each controller
   builds only its own rows, runs ``spmd_rs_setup`` over its
   ``SocketGroup`` and ``from_spmd`` with its ``DeviceComm``, and refines
   the float32 Chebyshev(3) hierarchy to 1e-8 with b = A 1: 15a's level
   sizes, operators and P (within 1e-12), 15a's refinements, the host
   residual below 1e-8, DIA and BDIA launched by every controller (their
   counts summed into the kernel list's ``2d_mc``); per controller the
   setup and pack seconds, one V-cycle's device and enqueue ms and its
   launches. Then every controller at once runs ``profile_cycle`` (20
   repetitions; ``print_times``' rows), printed beside the stacked 15a
   hierarchy's: each controller's rows have its levels, every time finite
   and above 0 (the transfer 0 on the coarsest level only), its launches
   are summed into ``2d_mc_profile``, and a V-cycle after it equals one
   before it bit for bit. (b) one float64 V-cycle of a 64^2 hierarchy on two
   controllers, on the card and on the CPU: equal to 1e-12 of max |x|.
   Its seconds and a JSON summary line (``phase16``) come before the
   kernel list;
17. TAP and the Krylov solvers across controllers: 8 controllers laid
   out as 2 hosts x 4. (a) each runs 16a's setup over
   ``comm.tapgroup.TapGroup`` (the node-aware schedule: 15a's levels,
   operators and P within 1e-12, TapGroup's inter- and intra-node sends
   summed) and ``from_spmd`` with TAP on every level, whose exchanges are
   all-to-alls over gloo sub-groups of a host's and of a local index's
   controllers: 15a's TAP refinements to 1e-8 with b = A 1, the host
   residual below 1e-8, 15a's TAP launches a cycle by every controller,
   one cycle's device and enqueue ms beside 16a's plain one. (b) on the
   plain ``from_spmd`` hierarchies, AMG-PCG, Pre-BiCGStab and GMRES(30)
   in float32 to 1e-5 (phase 10's runs) and a sequential-inner
   Pre-BiCGStab to 1e-8 on the float64 one, each in the iterations of
   the same run on 15a's per-rank setup stacked on the card, the float64
   run's x within 1e-12 of max |x| of the stacked one's. (c) one float64
   TAP V-cycle of a 64^2 hierarchy on 4 controllers as 2 x 2, on the card
   and on the CPU: equal to 1e-12 of max |x|. Its seconds and a JSON
   summary line (``phase17``) come before the kernel list;
18. systems AMG, RAP sparsification and the profiling layer; (a), and
   (b)'s two setups, on three controllers of the card
   (``run_controllers``) that set up and pack at the same time and then,
   once all are ready, run their timed work one at a time while the
   others wait. (a) phase
   12's Q1 elasticity matrix at ``--bsr`` as a scalar CSR, unknown-based:
   ``num_variables = 2`` with the gallery's variable ids, CLJP + modified
   classical, theta 0.25, Chebyshev(3), host engines; float32
   ``solve_mixed`` to 1e-8 with b = A 1 (at most the JAX package's
   refinements + 1), the
   setup's phase split, pack seconds, one cycle's device / enqueue / busy
   ms and launches, beside phase 12's blocked AMG on the same matrix;
   level 0's modified-classical interpolation with the variables replayed
   through the device engine on the card (the host P's pattern, values
   within 1e-14 of max |host|); a 24 x 24 float64 systems hierarchy on
   the card and on the CPU: one V-cycle within 1e-14 of max |x|, the
   solve to 1e-9 in the same cycles with x within 1e-12 (the gap printed
   after 1, 6 and 12 cycles and the solve's last). (b) RAP sparsification
   at (n/2)^2 (tests/test_multilevel.py::test_sparsify_large_2d: rotated
   anisotropic diffusion, CLJP + modified classical, theta 0.25,
   Chebyshev(3), ``sparsify_tol`` 0.4, the symmetric rule) beside the
   same setup unsparsified: per-level nnz, the coarse-to-fine nnz ratio
   below 2.5, every sparsified operator symmetric to 1e-10 and with its
   Galerkin product's row sums to 1e-12 (of that product's largest
   entry), and both solved as in (a). (c) the profiling layer on
   hierarchies the run holds: ``DeviceHierarchy.print_times`` (20
   repetitions) on phase 3's and phase 6's, five times each, each table
   beside a chain of V-cycles timed the same way right after (every
   level's smoother and SpMV time finite and above 0);
   ``pcg_time_split`` of phase 10's AMG-PCG; ``device_trace`` around one
   of phase 10's float32 V-cycles into build/trace18/, whose
   kernels must include DIA and BDIA; the communication model of every
   level of 14b's setup on 2 x 4 (TAP's bytes across hosts at most the
   plain plan's and equal to its G step's). (c)'s parts run where those
   hierarchies are held, and phase 18's JSON line (``phase18``) carries
   them;
19. the real-matrix path (the reference's examples/benchmark_nek5000.py
   flow) at 512^2 elements of the gallery's SIPG DG diffusion (1,048,576
   rows, 8 shards): assembled (in under 20 s), written to a ``.pm`` file
   and read back bit for bit (the ``.mtx`` round trip at 128^2); the
   edge cut and halo of the block, RCM and k-way partitions, the k-way
   repartition, the shards placed by ``Topology(8, ppn=4)``, the diagonal
   scaling; the distributed repartition (label propagation and the row
   migration over the in-process transport) equal to ``make_contiguous``
   on its labels bit for bit, and the k-way labels migrated over the
   transport equal to the global repartition; RS + modified classical,
   theta 0.25,
   Chebyshev(2), host engines, saved and reloaded equal level by level,
   and only the reloaded hierarchy packed (float64); AMG-PCG to 1e-8 in
   at most the JAX package's iterations + 1 with its levels, nnz and
   shard sizes, the unscaled x's residual on the original operator below
   1e-7, the formats and shard sizes of every level, the launches of one
   iteration of the solve, the device / enqueue / busy ms and launches by
   kernel name of a proxy step that launches as much; the kernels of
   A0 and P0 against their plain versions; a 32^2 pipeline solved on the
   card and on the CPU, x within 1e-12 of max |x|. Its JSON line
   (``dg_512``) comes before the kernel list;
20. the containers and the rest of the host library. (a) phase 3's
   operator at 1024^2 assembled by ``ParCOOMatrix`` from the stencil's
   entries split into exact halves in a seeded scrambled order (the
   stencil matrix bit for bit); phase 3's configuration as an
   ``AMGConfig`` carried through ``to_dict``, JSON and ``from_dict``,
   built and set up: its levels, A and P those of ``aniso_setup`` bit for
   bit; the float32 hierarchy refined to 1e-8 with b = A 1 (made through
   ``ParVector``, whose norm and inner product are held to numpy's) in at
   most the JAX package's 16 refinements plus one, DIA and BDIA launched
   (``2d_containers``); ParCSR's ``mult_T`` (on P0: A is symmetric)
   against ``ParCSCMatrix``'s transpose times x and ``residual`` against a
   numpy row sum, within 1e-14 of max. (b) phase 12's elasticity at 512 x 256 elements assembled block
   by block (exact halves, scrambled) by ``ParBCOOMatrix`` (par_fem's
   matrix bit for bit), ``ParBSRMatrix.to_device`` and ``bsr_spmv`` on the
   card within 1e-12 of max |y| of the host product, a ``ParBSCMatrix``
   round trip. (c) ``SerialMultilevel`` at 25^2 in the card's one-shard
   float64 cycles (residuals within rtol 1e-5, x within 1e-8), and
   ``solve_external``'s scipy CG at 40^2 (SSOR) to 1e-10 in under 30
   iterations. Each step's seconds and the peak RSS; its JSON line
   (``phase20``) comes before the kernel list;
21. the twins of the JAX package's example scripts (``examples_torch/``):
   each one's ``main`` called in this process on the card at its JAX
   script's default arguments (``EXAMPLES``; ``benchmark_tap_amg.py``,
   ``profile_amg.py`` and ``benchmark_setup_sweeps.py`` at smaller
   sides), its seconds, counts and kernel launches printed, every
   solve held to the JAX script's count at the same arguments on the CPU
   plus one (``EXAMPLE_HOLDS``; the deterministic host counts exactly,
   ``EXAMPLE_EXACT``; nek5000's PCG, which stops at its cap, by its final
   residual too, ``EX_FINAL_RES``), and every twin that runs on the
   device launching a ported kernel (the kernels of ``EX_REQUIRES``
   each). The matrix-file twins read the files the phase writes first
   (``example_inputs``: the rotated anisotropic operator at 256^2 as
   ``.pm``, the SIPG DG operator at 64^2 elements as ``.mtx``); the
   transfer-formats twin packs level 0's P and P^T at 48^3 in every
   format (windowed ELL, the sorted scatter and BELL launched); the
   overlap twin's two orders bit-equal, and a ``torch.profiler`` trace of
   a chain of each order (``overlap_trace``: the host's calls into CUDA
   against the device's busy time and gaps). Its JSON line (``phase21``),
   with the overlap's gain and trace and the L2 sweep's resident and
   cleared rates beside the flush's own time, comes before the kernel
   list.

The last two lines are the card's ``name, power.limit`` and then
``{"ok": true, "device": {...}}``; the line before them lists the kernels.
Needs one card; exits non-zero without CUDA or without the package.
"""

import argparse
import contextlib
import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

# the card's published peaks (NVIDIA H100 SXM data sheet): HBM3 bandwidth,
# and the non-tensor-core float32 / float64 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
# max |kernel - plain| / max |plain|. The kernels fuse multiply and add and
# sum in their own order; swellt_spmv_T adds with atomics, in an order that
# changes from run to run, as does the plain version's scatter_add_ on the
# card, and stays inside the same float32 limit.
TOL = {"float32": 1e-5, "float64": 1e-12}
# the line of raptor_tpu/device/pallas_kernels.py where the Pallas kernel
# each CUDA kernel replaces begins, and the kernel each packed format runs
REPLACES = {"dia_spmv": 47, "bdia_spmv": 112, "wind_ell_spmv": 189,
            "swellt_spmv_T": 327, "bell_spmv": 440}
FORMAT_KERNEL = {"dia": "dia_spmv", "bdia": "bdia_spmv",
                 "well": "wind_ell_spmv", "wellt": "swellt_spmv_T",
                 "bell": "bell_spmv"}


def phase(name, t0):
    """A phase's seconds and this process's peak resident set so far."""
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s; peak RSS "
          f"{peak_rss_mib():.1f} MiB", flush=True)


def time_ms(torch, fn, reps=20, warm=3):
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(torch, fn, reps=50, warm=3):
    """Device time of one call with the host's launch cost kept out: the
    calls are queued behind a spin kernel that lasts twice as long as the
    host takes to enqueue them, so the card runs them back to back; CUDA
    events around the batch, divided by ``reps``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms(torch)
                          * (2 * reps * host_ms + 1)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms(torch):
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def build(native, kernels):
    """Both builds at once: g++ in a thread, nvcc (one per source) here."""
    err = []

    def host():
        try:
            native.load()
        except BaseException as e:          # re-raised below
            err.append(e)

    t = threading.Thread(target=host)
    t.start()
    kernels.build()
    t.join()
    if err:
        raise err[0]


def aniso_setup(n, engines="host"):
    """Phase 3's setup; ``engines`` is its ``rap_mode`` and
    ``interp_mode`` (the other phases keep the host engines, as the JAX
    package's counts they are held to were taken with them)."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.max_levels = 25
    ml.rap_mode = ml.interp_mode = engines
    ml.setup(A)
    return A, ml


def operators(dh, ml):
    """(label, packed operator, host matrix thunk, embed) of every A, P and
    P^T of the hierarchy."""
    ops = []
    for i, (dl, hl) in enumerate(zip(dh.levels, ml.levels)):
        ops.append((f"A{i}", dl.A, lambda hl=hl: hl.A, None))
        if dl.P is not None:
            ops.append((f"P{i}", dl.P, lambda hl=hl: hl.P, "cols"))
            ops.append((f"Pt{i}", dl.Pt, lambda hl=hl: hl.P.transpose(),
                        "rows"))
    return ops


def well_slots(M):
    """Entries of the sliced windowed-ELL layout of ``M`` over all shards
    (``sptr[s, -1] * 32``; the padding of a shard past it is never read)."""
    from raptor_tpu_torch.device.formats import WELL_SLICE
    return int(M.wl_sptr[:, -1].sum()) * WELL_SLICE


def well_modelled_gather_sectors(torch, M, C):
    """A host model of the 32-byte sectors of x that the windowed-ELL
    kernel's gathers touch: per gather instruction (one slot of one
    slice, 32 lanes) the distinct sectors of the columns in [0, C), summed.
    Every lane of a slot gathers, the padding lanes of rows shorter than
    the slice too (their column 0 reads the window's first value). Counted
    from the sliced arrays, not read from the card's caches."""
    from raptor_tpu_torch.device.formats import LANE, WELL_SLICE
    per = 32 // M.wl_cvals.element_size()       # x values a sector
    total = 0
    for s in range(M.n_shards):
        width = (M.wl_sptr[s, 1:] - M.wl_sptr[s, :-1]).long()
        n = int(width.sum())
        slice_of = torch.repeat_interleave(
            torch.arange(len(width), device=M.device), width)
        tile = slice_of * WELL_SLICE // (M.wl_ba * LANE)
        e = slice(0, n * WELL_SLICE)
        col = (M.wl_ws[s, tile].long()[:, None] * LANE
               + M.wl_crel[s, e].reshape(n, WELL_SLICE).long())
        sec = (col // per).masked_fill(col >= C, -1).sort(dim=1).values
        total += int(((sec[:, 1:] != sec[:, :-1]) & (sec[:, 1:] >= 0)).sum()
                     + (sec[:, 0] >= 0).sum())
    return total


def needed_bytes(M):
    """Bytes of the packed arrays one on-block apply of ``M`` must read:
    the layout's bytes (``par.packed_bytes``, the format rule's count),
    but for BELL only the real slots (``bl_cnt``: values, lane ids, source
    block ids) and the counts, for the sorted scatter only the real
    entries (``wl_cnt``: values, metadata), the slot window bases and the
    counts, and for windowed ELL the real entries of its sliced layout
    (``well_slices``: columns and values of the nonzeros, not the padding
    lanes of a slice), the row map, the slice offsets and the window
    starts; the kernels read nothing else."""
    from raptor_tpu_torch.device.par import packed_bytes
    isz = M.on_vals.element_size()
    if M.on_format == "well":
        nnz = int((M.wl_cvals != 0).sum())
        return (nnz * (M.wl_crel.element_size() + isz)
                + 2 * M.wl_perm.numel() + 4 * M.wl_sptr.numel()
                + 4 * M.wl_ws.numel())
    if M.on_format == "bell":
        return (int(M.bl_cnt.sum()) * (128 * (1 + isz) + 4)
                + 4 * M.bl_cnt.numel())
    if M.on_format == "wellt":
        return (int(M.wl_cnt.sum()) * (4 + isz)
                + 4 * (M.wl_ws.numel() + M.wl_cnt.numel()))
    return packed_bytes(M)


def padded_bytes(M):
    """What a BELL, sorted-scatter or windowed-ELL kernel that walks the
    padded layout reads: every BELL or windowed-ELL slot; every
    sorted-scatter value, the metadata of the nonzero ones and the window
    bases."""
    from raptor_tpu_torch.device.par import packed_bytes
    n = packed_bytes(M)
    if M.on_format == "wellt":
        n -= 4 * int((M.on_vals == 0).sum())
    return n


def largest(dh, ml, fmt):
    """(label, packed operator, host matrix, embed) of the operator of the
    hierarchy in format ``fmt`` with the most packed bytes."""
    from raptor_tpu_torch.device.par import packed_bytes
    ops = [o for o in operators(dh, ml) if o[1].on_format == fmt]
    if not ops:
        raise AssertionError(f"no {fmt} operator in the hierarchy")
    label, M, host, embed = max(ops, key=lambda o: packed_bytes(o[1]))
    return label, M, host(), embed


def kernel_input_len(M):
    """Length of the x the on-block kernel reads (the embedded space for
    an operator embedded by columns)."""
    return M.rows_pad if M.embed_kind == "cols" else M.cols_pad


def kernel_spec(name, M, x):
    """(kernel call, plain call, bytes, operations) of one kernel on one
    packed operator: each input read once and the output written once, and
    a multiply-add per stored slot (per nonzero for BDIA, with its value,
    its lane index and the tile list, whatever share of the listed tiles'
    slots it fills; per lane of a real BELL slot; per entry with a value
    for the sorted-scatter and windowed-ELL kernels, which read no entry
    past a slot's count and no padded slot)."""
    from raptor_tpu_torch.device import formats, kernels
    S, C = x.shape
    isz = M.on_vals.element_size()
    if name == "dia_spmv":
        args = (M.dia_offsets, M.dia_vals, x, M.dia_pad)
        kern = (M.dia_offsets, M.dia_off) + args[1:]
        K, R = M.dia_vals.shape[1:]
        nbytes = S * ((K * R + C + R) * isz + 4 * K)
        ops = 2 * S * K * R
    elif name == "bdia_spmv":
        # the function needs each nonzero's value and 1-byte lane index,
        # the tile list and one offset per plane (the kernel reads every
        # slot of a listed tile: check_kernel's tile figures)
        args = (M.bd_offsets, M.bd_idx, M.bd_vals, x, M.bd_padb,
                M.on_rows_pad)
        kern = ((M.bd_offsets, M.bd_off) + args[1:]
                + (M.bd_tptr, M.bd_tplane))
        tiles = int(M.bd_tptr[:, -1].sum())
        nnz = int((M.bd_vals != 0).sum())
        nbytes = (nnz * (isz + 1) + 4 * (M.bd_tptr.numel() + tiles)
                  + S * (C + M.on_rows_pad) * isz + 4 * len(M.bd_offsets))
        ops = 2 * nnz
    elif name == "wind_ell_spmv":
        # the plain version of the same function on the same sliced arrays
        kern = (M.wl_ws, M.wl_perm, M.wl_sptr, M.wl_crel, M.wl_cvals, x,
                M.wl_ba, M.rows_pad)
        return (lambda: kernels.wind_ell_spmv(*kern),
                lambda: formats.well_slices_spmv(*kern),
                needed_bytes(M) + S * (C + M.rows_pad) * isz,
                2 * int((M.wl_cvals != 0).sum()))
    elif name == "swellt_spmv_T":
        args = (M.on_cols, M.on_vals, M.wl_ws, x, M.rows_pad)
        kern = args + (M.wl_cnt,)
        nbytes = needed_bytes(M) + S * (C + M.rows_pad) * isz
        ops = 2 * int((M.on_vals != 0).sum())
    else:
        args = (M.bl_src, M.bl_idx, M.bl_vals, x, M.on_rows_pad)
        kern = args + (M.bl_cnt,)
        nbytes = needed_bytes(M) + S * (C + M.on_rows_pad) * isz
        ops = 2 * 128 * int(M.bl_cnt.sum())
    return (lambda: getattr(kernels, name)(*kern),
            lambda: getattr(formats, name)(*args), nbytes, ops)


def torch_sparse(torch, host, dtype, gen):
    """The library yardstick: one torch.sparse CSR product of the same
    operator (timed here only; the port never calls it)."""
    g = host.global_csr
    sp = torch.sparse_csr_tensor(
        torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda(),
        torch.from_numpy(g.data).cuda().to(dtype), size=g.shape)
    xs = torch.randn(g.n_cols, generator=gen, device="cuda").to(dtype)
    return kernel_ms(torch, lambda: sp @ xs)


def bound(nbytes, ops, dt):
    """(least time in ms, what bounds it) at the card's published peaks."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FLOPS[dt] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def check_kernel(torch, name, M, host, gen):
    """One kernel on one packed operator: error against the plain version,
    kernel / plain / torch.sparse times, byte bound. The kernel and
    torch.sparse are timed back to back on the card (``kernel_ms``); the
    kernel also call by call (``call_ms``, the median of single calls
    each waited for, which holds the host's launch latency), as is the
    plain version."""
    from raptor_tpu_torch.device import kernels
    from raptor_tpu_torch.device.par import bdia_tile_share, packed_bytes
    dt = str(M.dtype).replace("torch.", "")
    x = torch.randn((M.n_shards, kernel_input_len(M)), generator=gen,
                    device="cuda").to(M.dtype)
    kern, plain, nbytes, ops = kernel_spec(name, M, x)
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.isfinite(got).all() or err > TOL[dt] * scale:
        raise AssertionError(f"{name} {dt}: max abs err {err} against max "
                             f"abs {scale} (limit {TOL[dt]} relative)")
    bound_ms, bound_by = bound(nbytes, ops, dt)
    c = {
        "dtype": dt, "max_abs_err": err, "rel_err": err / max(scale, 1e-300),
        "ms": kernel_ms(torch, kern), "call_ms": time_ms(torch, kern),
        "plain_ms": time_ms(torch, plain),
        "library_ms": torch_sparse(torch, host, M.dtype, gen),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": int(nbytes)}
    # and a layout figure, not a bound: the time of reading the packed
    # arrays whole (``packed_bytes``), x and the output at the memory rate
    packed = packed_bytes(M) + M.n_shards * (
        x.shape[1] + M.rows_pad) * M.on_vals.element_size()
    c.update(packed_bytes=int(packed),
             packed_read_ms=packed / PEAK_BYTES_PER_S * 1e3)
    if name == "bdia_spmv":
        # and two layout figures: the least time of a kernel that reads
        # every slot of the listed tiles (this one) and of one that streams
        # every plane of the row blocks below on_rows_pad (the
        # one-thread-per-row BDIA kernel)
        S, P = M.bd_vals.shape[:2]
        isz = M.bd_vals.element_size()
        dense = (S * P * M.on_rows_pad * (isz + 1) + 4 * P
                 + S * (x.shape[1] + M.on_rows_pad) * isz)
        tiles = int(M.bd_tptr[:, -1].sum())
        nnz = ops // 2
        tile_bytes = nbytes + (128 * tiles - nnz) * (isz + 1)
        c.update(tiles=tiles, tile_share=bdia_tile_share(M), nnz=nnz,
                 tile_fill=nnz / max(1, 128 * tiles),
                 tile_bytes=tile_bytes,
                 tile_bound_ms=bound(tile_bytes, 2 * 128 * tiles, dt)[0],
                 all_planes_bytes=dense,
                 all_planes_bound_ms=bound(dense, 2 * S * P * M.on_rows_pad,
                                           dt)[0])
    if name in ("bell_spmv", "swellt_spmv_T", "wind_ell_spmv"):
        # and the bound of a kernel that walks the padded layout
        n_out = M.on_rows_pad if name == "bell_spmv" else M.rows_pad
        isz = M.on_vals.element_size()
        padded = padded_bytes(M) + M.n_shards * (x.shape[1] + n_out) * isz
        c.update(padded_bytes=padded,
                 padded_bound_ms=bound(padded, ops, dt)[0])
    if name == "wind_ell_spmv":
        slots = well_slots(M)
        c.update(slots=slots, nnz=ops // 2, fill=ops / 2 / max(1, slots),
                 padded_slots=M.on_vals.numel(),
                 col_bytes=M.wl_crel.element_size(),
                 modelled_gather_sectors=well_modelled_gather_sectors(
                     torch, M, x.shape[1]))
    if name == "bell_spmv":
        c.update(real_slots=int(M.bl_cnt.sum()),
                 slots=M.bl_vals.shape[0] * M.bl_vals.shape[1]
                 * M.bl_vals.shape[2],
                 live_blocks=int((M.bl_cnt > 0).sum()),
                 warps=kernels.bell_warps(M.bl_vals.shape[1]))
    if name == "swellt_spmv_T":
        # the global atomics the design issues: a model counted on the host
        # from the packed arrays at the built kernel's launch shape, not a
        # reading of the card
        group, span = kernels.swellt_launch_shape(M.on_vals.shape[2] // 128)
        c.update(nnz=ops // 2, real_entries=int(M.wl_cnt.sum()),
                 group=group, span=span,
                 modelled_global_atomics=(
                     kernels.swellt_modelled_global_atomics(
                         M.on_cols, M.on_vals, M.wl_ws, M.wl_cnt, M.rows_pad,
                         group, span)))
    return c


def detail(c):
    """The layout's figures of one check, for its printed line."""
    if "tiles" in c:
        return (f", {c['nnz']} nonzeros in {c['tiles']} tiles = "
                f"{c['tile_share']:.1%}, {c['tile_fill']:.1%} of their slots "
                f"filled; every slot of the listed tiles {c['tile_bytes']} B, "
                f"bound {c['tile_bound_ms']:.4f} ms; every plane "
                f"{c['all_planes_bytes']} B, bound "
                f"{c['all_planes_bound_ms']:.4f} ms")
    if "real_slots" in c:
        return (f", {c['real_slots']} of {c['slots']} slots real in "
                f"{c['live_blocks']} row blocks, {c['warps']} warps; padded "
                f"layout {c['padded_bytes']} B, bound "
                f"{c['padded_bound_ms']:.4f} ms")
    if "col_bytes" in c:
        return (f", sliced {c['slots']} slots of {c['padded_slots']} padded"
                f", fill {c['fill']:.3f}, {c['col_bytes']}-byte columns, "
                f"x gathers touch {c['modelled_gather_sectors']} sectors "
                f"of 32 B by the host model "
                f"({c['modelled_gather_sectors'] / max(1, c['nnz']):.3f} "
                f"a nonzero); "
                f"padded layout {c['padded_bytes']} B, bound "
                f"{c['padded_bound_ms']:.4f} ms")
    if "modelled_global_atomics" in c:
        return (f", {c['real_entries']} real entries, {c['nnz']} nonzeros, "
                f"{c['modelled_global_atomics']} global atomics by the host "
                f"model of {c['group']} tiles a CTA and a {c['span']}-block "
                f"window; padded layout {c['padded_bytes']} B, bound "
                f"{c['padded_bound_ms']:.4f} ms")
    return ""


def run_checks(torch, cases, lane_pad, gen, checks):
    """``cases``: (kernel, label, packed operator, host, embed); each is
    checked in float32 and float64, as it is in its own dtype and repacked
    in the same format in the other."""
    from raptor_tpu_torch.device.par import device_put_matrix
    for name, label, M32, host, embed in cases:
        for dtype in (torch.float32, torch.float64):
            M = M32
            if dtype != M32.dtype:
                M = device_put_matrix(
                    host, dtype=dtype, lane_pad=lane_pad,
                    embed=embed if M32.embed_kind != "none" else None,
                    force_format=(M32.on_format if M32.on_format in
                                  ("well", "wellt", "bell") else None),
                    need_transpose=False)
            if FORMAT_KERNEL.get(M.on_format) != name:
                raise AssertionError(f"{label} packed as {M.on_format}")
            if not (torch.equal(M.bd_tptr, M32.bd_tptr)
                    and torch.equal(M.bd_tplane, M32.bd_tplane)
                    and torch.equal(M.bl_cnt, M32.bl_cnt)
                    and torch.equal(M.wl_cnt, M32.wl_cnt)
                    and torch.equal(M.wl_perm, M32.wl_perm)
                    and torch.equal(M.wl_sptr, M32.wl_sptr)):
                raise AssertionError(f"{label}: the {dtype} pack lists "
                                     f"other tiles, slots or entries than "
                                     f"the {M32.dtype} one")
            c = check_kernel(torch, name, M, host, gen)
            c["operator"] = label
            checks.setdefault(name, []).append(c)
            print(f"  {name} on {label} ({c['dtype']}): rel err "
                  f"{c['rel_err']:.3e}, kernel {c['ms']:.4f} ms (call by "
                  f"call {c['call_ms']:.4f} ms), plain "
                  f"{c['plain_ms']:.4f} ms, torch.sparse "
                  f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bytes']} B{detail(c)}; the packed arrays "
                  f"{c['packed_bytes']} B, read whole in "
                  f"{c['packed_read_ms']:.4f} ms)", flush=True)
            del M


def level_times(torch, dh, reps=20):
    """Device time of each level's share of one V-cycle: smoothing,
    residual, restriction and prolongation (the coarse solve on the
    coarsest level), by CUDA events."""
    from raptor_tpu_torch.device.par import spmv
    rows = []
    for i, lvl in enumerate(dh.levels):
        S, R = lvl.A.n_shards, lvl.A.rows_pad
        b = torch.ones((S, R), dtype=dh.dtype, device="cuda")
        if lvl.P is None:
            rows.append(time_ms(torch,
                                lambda: dh.coarse_solve(lvl.A.row_mask, b),
                                reps))
            continue
        xc = torch.ones((S, lvl.Pt.rows_pad), dtype=dh.dtype, device="cuda")

        def share(lvl=lvl, b=b, xc=xc):
            x = dh.relax(lvl, torch.zeros_like(b), b)
            spmv(lvl.Pt, b - spmv(lvl.A, x))
            x = x + spmv(lvl.P, xc)
            return dh.relax(lvl, x, b)
        rows.append(time_ms(torch, share, reps))
    return rows


def device_kernels(torch, fn):
    """(name, ms) of every kernel one call runs, from torch.profiler's
    device trace; empty when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_busy(torch, fn):
    """(kernel count, summed kernel ms) of one call (``device_kernels``);
    (0, 0.0) when the profiler records no device activity."""
    kern = device_kernels(torch, fn)
    return len(kern), sum(ms for _, ms in kern)


def reference_check(torch, setup, n, b_of):
    """A small problem solved on the card and with the plain versions on
    the CPU (float64): the residual histories must agree."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    A, ml = setup(n)
    b = A.mult(b_of(A.global_num_rows))
    out = {}
    for dev in ("cuda", "cpu"):
        dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=128,
                             device=dev)
        dh.solve_tol = 1e-9
        out[dev] = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    g, c = out["cuda"], out["cpu"]
    k = c.n_iters
    if g.n_iters != k or not np.allclose(g.res[:k + 1], c.res[:k + 1],
                                         rtol=1e-9, atol=1e-16):
        raise AssertionError(f"card and CPU disagree at n = {n}: "
                             f"{g.res[:k + 1]} vs {c.res[:k + 1]}")
    return k, float(c.res[k])


def lap27_setup(n, engines="host"):
    """Phase 6's setup (``engines`` as in ``aniso_setup``)."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        laplace_stencil_27pt, par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.max_levels = 25
    ml.rap_mode = ml.interp_mode = engines
    ml.setup(A)
    return A, ml


def example_setup(n, relax_type, sweeps=1):
    """The reference's example runs (examples/example.py,
    examples/benchmark_pcg.py): n x n rotated anisotropic diffusion on one
    shard, CLJP + modified classical, theta 0.25."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=relax_type)
    ml.num_smooth_sweeps = sweeps
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    return A, ml


def require_launches(what, launches, names=("dia_spmv", "bdia_spmv")):
    """Fail when a kernel of a path was launched no time in its run."""
    idle = [name for name in names if launches[name] == 0]
    if idle:
        raise AssertionError(f"{what}: kernels of the path did not run: "
                             f"{idle} ({launches})")


# phase 10: the JAX package's V-cycles to 1e-7 of the SOR example at side
# N (``JAX_PLATFORMS=cpu python examples/example.py N 1``), the most the
# port may take there; the smoothers beside SOR, each one solve of at most
# SMOOTHER_CYCLES V-cycles. The phase runs at 128^2 (256^2 and 512^2
# before, each cut to make room for a new phase, 21 and 19)
SOR_CYCLES = {512: 36, 256: 29, 128: 23}
SMOOTHERS = ("SSOR", "Jacobi", "L1Jacobi", "MCSOR", "MCSSOR")
SMOOTHER_CYCLES = 10


# phase 11: the JAX package's smoothed-aggregation level sizes and its
# refinements to 1e-8 (float32 hierarchy, b = A 1; the port may take one
# more), from a CPU run of the JAX package at side N:
#   JAX_PLATFORMS=cpu python -c "import sys, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.aggregation.solver import ParSmoothedAggregationSolver \
#   as SA; from raptor_tpu.core.types import RelaxType; from \
#   raptor_tpu.device.par import make_mesh; from raptor_tpu.gallery.stencils \
#   import laplace_stencil_27pt as L, par_stencil_grid as G; from \
#   raptor_tpu.multilevel.device_hierarchy import DeviceHierarchy as DH; \
#   n = int(sys.argv[1]); A = G(L(), (n,) * 3, 1); ml = SA(0.0, \
#   relax_type=RelaxType.Chebyshev); ml.num_smooth_sweeps = 2; \
#   ml.rap_mode = 'host'; ml.setup(A); b = A.mult(np.ones(n ** 3)); _, h = \
#   DH(ml, make_mesh(1), dtype=jnp.float32).solve_mixed(np.zeros(n ** 3), \
#   b, tol=1e-8, max_iter=200); print([l.A.global_num_rows for l in \
#   ml.levels], len(h) - 1, h[-1])" N
SA_LEVELS = {64: [262144, 6101, 89, 1], 128: [2097152, 46779, 549, 8]}
SA_REFINEMENTS = {64: 27, 128: 44}
# the operators whose kernels phase 11 checks at each of its two sides, and
# the formats the card's rules give them at 128^3 and 64^3
SA_CHECKS = {"3d_sa": ("P0", "Pt0", "A1", "P1"), "3d_sa64": ("Pt0",)}
SA_FORMATS = {128: {"P0": "well", "Pt0": "well", "A1": "bdia", "P1": "bdia"},
              64: {"Pt0": "wellt"}}


def sa_setup(n, engines="host"):
    """bench.py:bench_sa's smoothed-aggregation setup on the n^3 27-point
    Laplacian, one shard (``engines`` as in ``aniso_setup``)."""
    from raptor_tpu_torch.aggregation.solver import (
        ParSmoothedAggregationSolver)
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        laplace_stencil_27pt, par_stencil_grid)
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 1)
    ml = ParSmoothedAggregationSolver(0.0, relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.rap_mode = ml.interp_mode = engines
    ml.setup(A)
    return A, ml


def smoothed_aggregation(torch, n, kernels, by_path, key):
    """Phase 11 at side n (see the module docstring): setup, packing and
    the float32 solve, with its launches under ``by_path[key + "_solve"]``;
    returns (summary, device hierarchy, host hierarchy)."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    t0 = time.perf_counter()
    A, ml = sa_setup(n)
    setup_s = time.perf_counter() - t0
    print(ml.print_hierarchy())
    print(ml.print_setup_times())
    sizes = [lvl.A.global_num_rows for lvl in ml.levels]
    print(f"SA setup at {n}^3: {ml.num_levels} levels {sizes} in "
          f"{setup_s:.3f} s")
    if n in SA_LEVELS and sizes != SA_LEVELS[n]:
        raise AssertionError(f"SA levels at {n}^3 {sizes}, the JAX "
                             f"package's {SA_LEVELS[n]}")
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float32)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    print(f"SA device hierarchy (float32, lane_pad {dh.lane_pad}): "
          f"{pack_s:.3f} s")
    formats = dh.format_summary()
    print("\n".join(formats))
    b = A.mult(np.ones(n ** 3))
    limit = SA_REFINEMENTS[n] + 1 if n in SA_REFINEMENTS else None
    k, by_path[f"{key}_solve"], solve_s = drive_solve(
        torch, dh, A, b, f"SA {n}^3, b = A 1", kernels, limit=limit)
    t0 = time.perf_counter()
    _, hist = dh.solve_mixed(np.zeros(n ** 3), b, tol=1e-8, max_iter=100,
                             return_device=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"solve (SA {n}^3, warm): {len(hist) - 1} refinements in "
          f"{warm_s:.3f} s")
    cyc = cycle_report(torch, dh, b, kernels)
    return ({"n": n, "levels": sizes, "setup_s": setup_s,
             "setup_phases": ml.setup_level_times, "pack_s": pack_s,
             "formats": formats, "solve_refinements_ones": k,
             "jax_refinements": SA_REFINEMENTS.get(n),
             "solve_s_first": solve_s, "solve_s_warm": warm_s, **cyc},
            dh, ml)


# phase 12: the JAX package's blocked-AMG level sizes, its blocked V-cycles
# to 1e-6 and its BSR-PCG iterations to 1e-10 (float64, b = A 1, block
# Chebyshev(3)), the most the port may take, from a CPU run of the JAX
# package at NX x NY elements:
#   JAX_PLATFORMS=cpu python examples/benchmark_bsr_amg.py NX NY 1
BSR_LEVELS = {(1024, 512): [1050624, 262146, 65790, 16768, 4282, 1120, 296,
                            100],
              (128, 64): [16640, 4156, 1054, 306, 100]}
BSR_CYCLES = {(1024, 512): 31, (128, 64): 34}
BSR_PCG = {(1024, 512): 31, (128, 64): 27}
BSR_SMALL = (128, 64)          # bench.py:bench_bsr's size
# the levels whose nodal P_c and P_c^T the card's rules pack as windowed
# ELL (the levels below are BDIA), and the scalar A0's format
BSR_WELL_LEVELS = {(1024, 512): 2, (128, 64): 0}


def bsr_setup(nx, ny):
    """bench.py:bench_bsr's setup: nx x ny plane-stress elasticity on one
    shard, blocked RS + modified classical, classical strength, theta
    0.25."""
    from raptor_tpu_torch import ParBSRRugeStubenSolver, par_fem
    A, _ = par_fem("elasticity", nx, ny, 1)
    ml = ParBSRRugeStubenSolver(2, strong_threshold=0.25)
    ml.setup(A)
    return A, ml


def bsr_operators(dh, ml):
    """(label, level, packed operator, host matrix thunk) of every nodal
    P_c and P_c^T of a blocked hierarchy ("Pn0[1]": level 0, component
    1)."""
    from raptor_tpu_torch.multilevel.bsr_hierarchy import nodal_transfers
    ops = []
    for i, lvl in enumerate(dh.levels[:-1]):
        for c, (P, Pt) in enumerate(zip(lvl.Pn, lvl.PnT)):
            ops.append((f"Pn{i}[{c}]", i, P,
                        lambda i=i, c=c: nodal_transfers(ml, i)[c]))
            ops.append((f"PnT{i}[{c}]", i, Pt,
                        lambda i=i, c=c: nodal_transfers(ml, i)[c]
                        .transpose()))
    return ops


def bsr_level_times(torch, dh, reps=20):
    """Device time of each level's share of one blocked V-cycle: the two
    smoothings, the residual, restriction and prolongation (the coarse
    solve on the coarsest level), by CUDA events."""
    from raptor_tpu_torch.device.bsr import bsr_spmv
    rows = []
    for i, lvl in enumerate(dh.levels):
        S, rb = lvl.Ab.n_shards, lvl.Ab.brows_pad
        b = torch.ones((S, rb * dh.b), dtype=dh.dtype, device="cuda")
        if lvl.Pn is None:
            rows.append(time_ms(torch, lambda b=b: dh._coarse_solve(b),
                                reps))
            continue
        rbc = dh.levels[i + 1].Ab.brows_pad
        ec = torch.ones((S, rbc * dh.b), dtype=dh.dtype, device="cuda")

        def share(lvl=lvl, b=b, ec=ec, rb=rb, rbc=rbc):
            x = dh._block_jacobi(lvl, torch.zeros_like(b), b)
            dh._restrict(lvl.PnT, b - bsr_spmv(lvl.Ab, x), rbc)
            x = x + dh._prolong(lvl.Pn, ec, rb)
            return dh._block_jacobi(lvl, x, b)
        rows.append(time_ms(torch, share, reps))
    return rows


def bsr_cycle_report(torch, dh, b, kernels):
    """One float64 blocked V-cycle: launches per kernel, device ms by CUDA
    events, host enqueue ms, per-level ms, and the profiler's busy time,
    whole and split by kernel name (the largest ten)."""
    n = len(b)
    xd = dh.vector(np.zeros(n))
    bd = dh.vector(b / np.linalg.norm(b))
    kernels.reset_launches()
    dh.vcycle(xd, bd)
    torch.cuda.synchronize()
    per_cycle = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    dh.vcycle(xd, bd)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    cycle_ms = time_ms(torch, lambda: dh.vcycle(xd, bd), reps=10)
    lv = bsr_level_times(torch, dh)
    kern = device_kernels(torch, lambda: dh.vcycle(xd, bd))
    busy_ms = sum(ms for _, ms in kern)
    by_name = {}
    for name, ms in kern:
        cnt, tot = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, tot + ms)
    split = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    busy = (f"{len(kern)} kernels, {busy_ms:.3f} ms busy = "
            f"{busy_ms / cycle_ms:.1%} of the cycle" if kern
            else "device busy share not measured (no profiler trace)")
    print(f"blocked V-cycle (float64): {cycle_ms:.3f} ms on the card, host "
          f"enqueue {enqueue_ms:.3f} ms; {busy}; ported-kernel launches per "
          f"cycle {per_cycle}")
    for i, t in enumerate(lv):
        print(f"  level {i:2d}: {dh.levels[i].Ab.global_num_rows:8d} rows "
              f"{t:8.4f} ms")
    print(f"  sum of levels {sum(lv):.3f} ms")
    print("  busy time by kernel name (launches, ms, share of busy):")
    for name, (cnt, ms) in split:
        print(f"    {cnt:5d} {ms:8.3f} {ms / max(busy_ms, 1e-12):6.1%}  "
              f"{name[:110]}")
    return {"vcycle_ms": cycle_ms, "vcycle_enqueue_ms": enqueue_ms,
            "vcycle_kernels": len(kern), "vcycle_busy_ms": busy_ms,
            "level_ms": lv, "launches_per_vcycle": per_cycle,
            "busy_by_name": [{"name": name, "launches": cnt, "ms": ms}
                             for name, (cnt, ms) in split]}


def bsr_formats(dh, ml, nx, ny):
    """Fail when a nodal transfer of a size the JAX package's counts hold
    is not in the format the card's rules give it; returns the kernels of
    the cycle (one per format of its nodal transfers)."""
    ops = bsr_operators(dh, ml)
    if (nx, ny) in BSR_WELL_LEVELS:
        for label, level, M, _ in ops:
            want = "well" if level < BSR_WELL_LEVELS[(nx, ny)] else "bdia"
            if M.on_format != want:
                raise AssertionError(f"BSR {nx} x {ny} {label} packed as "
                                     f"{M.on_format}, not {want}")
    return sorted({FORMAT_KERNEL[M.on_format] for _, _, M, _ in ops
                   if M.on_format in FORMAT_KERNEL})


def blocked_amg(torch, nx, ny, kernels, by_path, key):
    """Phase 12 at nx x ny elements (see the module docstring): setup,
    packing, the blocked solve and BSR-PCG, with their launches under
    ``by_path[key + "_solve"]`` and ``by_path[key + "_pcg"]``; returns
    (summary, device hierarchy, host hierarchy)."""
    from raptor_tpu_torch import BSRDeviceHierarchy
    from raptor_tpu_torch.device import par as dpar
    from raptor_tpu_torch.krylov.cg import cg
    t0 = time.perf_counter()
    A, ml = bsr_setup(nx, ny)
    setup_s = time.perf_counter() - t0
    print(ml.print_hierarchy())
    print(ml.print_setup_times())
    sizes = [lvl.A.global_num_rows for lvl in ml.levels]
    phases = dict(ml.setup_times.times)
    print(f"BSR setup at {nx} x {ny}: {ml.num_levels} levels {sizes} in "
          f"{setup_s:.3f} s; phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(phases.items())))
    if (nx, ny) in BSR_LEVELS and sizes != BSR_LEVELS[(nx, ny)]:
        raise AssertionError(f"BSR levels at {nx} x {ny} {sizes}, the JAX "
                             f"package's {BSR_LEVELS[(nx, ny)]}")
    t0 = time.perf_counter()
    dh = BSRDeviceHierarchy(ml, sweeps=3)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    pack = dict(dh.pack_times.times)
    print(f"BSR device hierarchy (float64, lane_pad {dh.lane_pad}): "
          f"{pack_s:.3f} s; blocked operators {pack['blocked']:.3f} s, "
          f"nodal transfers {pack['transfers']:.3f} s, Chebyshev intervals "
          f"{pack['chebyshev']:.3f} s")
    formats = dh.format_summary()
    print("\n".join(formats))
    path = bsr_formats(dh, ml, nx, ny)

    # the blocked V-cycle to 1e-6
    n = A.global_num_rows
    b = A.mult(np.ones(n))
    xd, bd = dh.vector(np.zeros(n)), dh.vector(b)
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, hist, k = dh.solve(xd, bd, tol=1e-6, max_iter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = by_path[f"{key}_solve"] = dict(kernels.LAUNCHES)
    xh = dh.host(x)
    relres = float(np.linalg.norm(b - A.mult(xh)) / np.linalg.norm(b))
    print(f"blocked solve ({nx} x {ny}, b = A 1): {k} V-cycles to "
          f"{hist[k]:.3e} (host-recomputed {relres:.3e}) in {solve_s:.3f} s,"
          f" first call; launches {launches}", flush=True)
    if not (np.isfinite(xh).all() and xh.shape == (n,)):
        raise AssertionError("BSR solution is not finite or has the wrong "
                             "shape")
    limit = BSR_CYCLES.get((nx, ny), 100)
    if hist[k] > 1e-6 or k > limit or relres > 2e-6:
        raise AssertionError(f"BSR {nx} x {ny}: no 1e-6 within {limit} "
                             f"cycles: {hist[:k + 1]} (host {relres})")
    require_launches(f"BSR solve {nx} x {ny}", launches, path)
    t0 = time.perf_counter()
    dh.solve(xd, bd, tol=1e-6, max_iter=100)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"blocked solve (warm): {warm_s:.3f} s")

    # float64 PCG on the scalar level-0 A with the blocked V-cycle
    Ab = ml.levels[0].A
    A64 = dpar.device_put_matrix(Ab, dtype=torch.float64,
                                 lane_pad=dh.lane_pad, need_transpose=False)

    def vec(v):
        return dpar.device_put_vector(v, Ab.partition.row_bounds,
                                      A64.rows_pad, dtype=torch.float64)

    pre = dh.precond_pack()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = cg(A64, vec(np.zeros(n)), vec(b), tol=1e-10, max_iter=200,
           precond=pre)
    torch.cuda.synchronize()
    pcg_s = time.perf_counter() - t0
    launches = by_path[f"{key}_pcg"] = dict(kernels.LAUNCHES)
    it = r.n_iters
    xp = dpar.host_vector(r.x, Ab.partition.row_bounds)
    prel = float(np.linalg.norm(b - A.mult(xp)) / np.linalg.norm(b))
    print(f"BSR-PCG ({nx} x {ny}, A0 {A64.on_format}): {it} iterations to "
          f"{r.res[it]:.3e} (host-recomputed {prel:.3e}) in {pcg_s:.3f} s, "
          f"{pcg_s / max(1, it) * 1e3:.1f} ms an iteration; launches "
          f"{launches}", flush=True)
    plimit = BSR_PCG.get((nx, ny), 200)
    if (not r.res[it] <= 1e-10 or it > plimit or r.indefinite
            or not np.isfinite(xp).all()):
        raise AssertionError(f"BSR-PCG {nx} x {ny}: no 1e-10 within "
                             f"{plimit}: {r.res[:it + 1]}")
    require_launches(f"BSR-PCG {nx} x {ny}", launches,
                     sorted(set(path) | {"dia_spmv"}))
    cyc = bsr_cycle_report(torch, dh, b, kernels)
    return ({"nx": nx, "ny": ny, "levels": sizes, "setup_s": setup_s,
             "setup_phases": phases,
             "setup_level_phases": ml.setup_level_times, "pack_s": pack_s,
             "pack_phases": pack, "formats": formats, "a0_format":
             A64.on_format, "cycles": k, "jax_cycles": BSR_CYCLES.get(
                 (nx, ny)), "res": float(hist[k]), "host_res": relres,
             "solve_s_first": solve_s, "solve_s_warm": warm_s,
             "pcg_iters": it, "jax_pcg_iters": BSR_PCG.get((nx, ny)),
             "pcg_res": float(r.res[it]), "pcg_s": pcg_s, **cyc},
            dh, ml)


def block_spmv_report(torch, dh, ml, gen):
    """One float64 block SpMV on the blocked A0, timed back to back
    (``kernel_ms``) beside its bound (the packed blocks and block column
    ids read once, x read and y written once) and a torch.sparse CSR
    product of the scalar A0; checked against the host product."""
    from raptor_tpu_torch.device import par as dpar
    from raptor_tpu_torch.device.bsr import bsr_spmv
    B = dh.levels[0].Ab
    A = ml.levels[0].A
    S, n_in = B.n_shards, B.bcols_pad * B.b_cols
    x = torch.randn((S, n_in), generator=gen, device="cuda",
                    dtype=torch.float64)
    y = dpar.host_vector(bsr_spmv(B, x), A.partition.row_bounds)
    ref = A.mult(dpar.host_vector(x, A.partition.col_bounds))
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    if not err <= TOL["float64"]:
        raise AssertionError(f"block SpMV on A0: rel err {err}")
    ms = kernel_ms(torch, lambda: bsr_spmv(B, x))
    blocks = B.on_blocks.numel() + B.off_blocks.numel()
    nbytes = (blocks * B.on_blocks.element_size()
              + 8 * (B.on_cols.numel() + B.off_cols.numel()
                     + B.off_rows.numel())
              + 8 * (x.numel() + S * B.brows_pad * B.b_rows))
    bound_ms, bound_by = bound(nbytes, 2 * blocks, "float64")
    lib = torch_sparse(torch, A, torch.float64, gen)
    print(f"block SpMV on A0 ({A.global_num_rows} rows, {B.b_rows} x "
          f"{B.b_cols} blocks, width {B.on_cols.shape[1]}): {ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes} B, {bound_by}), torch.sparse "
          f"CSR of the scalar A0 {lib:.4f} ms, rel err {err:.2e}",
          flush=True)
    return {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": int(nbytes), "library_ms": lib, "rel_err": err}


def bsr_kernel_cases(torch, dh, ml):
    """The kernels of the blocked path on its own operators, packed in
    float32 as the card packs them (``run_checks`` repacks each in
    float64): windowed ELL on Pn0 (component 0) and PnT0 where they took
    it, BDIA on the largest BDIA nodal operator, DIA on the scalar A0."""
    from raptor_tpu_torch.device.par import device_put_matrix, packed_bytes

    def f32(host):
        return device_put_matrix(host, dtype=torch.float32,
                                 lane_pad=dh.lane_pad, need_transpose=False)

    ops = {label: (M, host) for label, _, M, host in bsr_operators(dh, ml)}
    cases = []
    for label in ("Pn0[0]", "PnT0[0]"):
        M, host = ops[label]
        if M.on_format == "well":
            h = host()
            cases.append(("wind_ell_spmv", f"BSR {label}", f32(h), h, None))
    bdia = [(label, M, host) for label, (M, host) in ops.items()
            if M.on_format == "bdia"]
    if bdia:
        label, _, host = max(bdia, key=lambda o: packed_bytes(o[1]))
        h = host()
        cases.append(("bdia_spmv", f"BSR {label}", f32(h), h, None))
    A0 = ml.levels[0].A
    cases.append(("dia_spmv", "BSR A0", f32(A0), A0, None))
    return cases


def bsr_reference_check(torch, nx, ny):
    """A small blocked solve on the card and with the plain versions on the
    CPU (float64, lane_pad 128 on both): equal cycle counts, histories to
    1e-9."""
    from raptor_tpu_torch import BSRDeviceHierarchy
    A, ml = bsr_setup(nx, ny)
    b = A.mult(np.ones(A.global_num_rows))
    out = {}
    for dev in ("cuda", "cpu"):
        dh = BSRDeviceHierarchy(ml, sweeps=3, lane_pad=128, device=dev)
        _, hist, k = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b),
                              tol=1e-6, max_iter=100)
        out[dev] = (hist, k)
    (g, kg), (c, kc) = out["cuda"], out["cpu"]
    if kg != kc or not np.allclose(g, c, rtol=1e-9, atol=1e-16):
        raise AssertionError(f"BSR card and CPU disagree at {nx} x {ny}: "
                             f"{g[:kg + 1]} vs {c[:kc + 1]}")
    return kc, float(c[kc])


def blocked_amg_phase(torch, size, kernels, by_path, gen, checks):
    """Phase 12: the blocked solve and PCG at ``size`` and at BSR_SMALL,
    the block SpMV on the first one's A0, the 24 x 12 card-against-CPU
    check, and the kernels on the first one's operators; returns the
    summaries by key."""
    summary = {}
    for (nx, ny), key in ((size, "2d_bsr"), (BSR_SMALL, "2d_bsr128")):
        summary[key], dh, ml = blocked_amg(torch, nx, ny, kernels, by_path,
                                           key)
        if key == "2d_bsr":
            summary[key]["block_spmv"] = block_spmv_report(torch, dh, ml,
                                                           gen)
            cases = bsr_kernel_cases(torch, dh, ml)
        del dh, ml
    k, res = bsr_reference_check(torch, 24, 12)
    print(f"reference: 24 x 12 float64 blocked solve, card == CPU plain "
          f"versions ({k} cycles to {res:.3e})")
    run_checks(torch, cases, 128, gen, checks)
    del cases
    torch.cuda.empty_cache()
    return summary


def sor_krylov(torch, nk, kernels, by_path):
    """Phase 10 (see the module docstring); returns its summary."""
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device import par as dpar
    from raptor_tpu_torch.krylov.bicgstab import bicgstab
    from raptor_tpu_torch.krylov.cg import cg
    from raptor_tpu_torch.krylov.gmres import gmres
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    n = nk * nk
    t0 = time.perf_counter()
    A, ml = example_setup(nk, RelaxType.SOR)
    setup_s = time.perf_counter() - t0
    print(ml.print_hierarchy())
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float64)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    print(f"setup: {ml.num_levels} levels in {setup_s:.3f} s; float64 "
          f"SOR hierarchy packed in {pack_s:.3f} s")
    print("\n".join(dh.format_summary()))
    fwd = [lvl.RX.n_fwd_levels for lvl in dh.levels[:-1]]
    bwd = [lvl.RX.n_bwd_levels for lvl in dh.levels[:-1]]
    print(f"schedule levels per level, forward {fwd} (sum {sum(fwd)}), "
          f"backward {bwd} (sum {sum(bwd)})")

    # 1. the example run: SOR(1) to 1e-7
    b = A.mult(np.ones(n))
    xd, bd = dh.vector(np.zeros(n)), dh.vector(b)
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = dh.solve(xd, bd)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    by_path["sor_solve"] = dict(kernels.LAUNCHES)
    k = r.n_iters
    x = dh.host(r.x)
    relres = float(np.linalg.norm(b - A.mult(x)) / np.linalg.norm(b))
    print(f"SOR solve: {k} V-cycles to {r.res[k]:.3e} (host-recomputed "
          f"{relres:.3e}) in {solve_s:.3f} s, {solve_s / max(1, k) * 1e3:.1f}"
          f" ms a cycle; launches {by_path['sor_solve']}", flush=True)
    if not (np.isfinite(x).all() and x.shape == (n,)):
        raise AssertionError("SOR solution is not finite or has the wrong "
                             "shape")
    limit = SOR_CYCLES.get(nk, dh.max_iterations)
    if (r.res[k] > 1e-7 or k > limit or r.stalled
            or not np.isclose(relres, r.res[k], rtol=1e-6)):
        raise AssertionError(f"SOR: no 1e-7 within {limit} cycles: "
                             f"{r.res[:k + 1]} (host {relres})")
    require_launches("SOR solve", by_path["sor_solve"])
    sor_res = float(r.res[k])

    kernels.reset_launches()
    dh.vcycle(xd, bd)
    torch.cuda.synchronize()
    per_cycle = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    dh.vcycle(xd, bd)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    cycle_ms = time_ms(torch, lambda: dh.vcycle(xd, bd), reps=3, warm=1)
    n_kern, busy_ms = device_busy(torch, lambda: dh.vcycle(xd, bd))
    busy = (f"{n_kern} kernels, {busy_ms:.3f} ms busy = "
            f"{busy_ms / cycle_ms:.1%} of the cycle" if n_kern
            else "device busy share not measured (no profiler trace)")
    print(f"SOR V-cycle (float64): {cycle_ms:.3f} ms on the card, host "
          f"enqueue {enqueue_ms:.3f} ms; {busy}; ported-kernel launches "
          f"per cycle {per_cycle}", flush=True)
    kr, res = reference_check(
        torch, lambda m: example_setup(m, RelaxType.SOR), 64, np.ones)
    print(f"reference: 64^2 float64 SOR solve, card == CPU plain versions "
          f"({kr} cycles to {res:.3e})")
    del dh, xd, r

    # 2. the other smoothers on the same setup, float64
    smoothers = {}
    kernels.reset_launches()
    for name in SMOOTHERS:
        ml.relax_type = getattr(RelaxType, name)
        dhs = DeviceHierarchy(ml, dtype=torch.float64)
        dhs.max_iterations = SMOOTHER_CYCLES
        t0 = time.perf_counter()
        rs = dhs.solve(dhs.vector(np.zeros(n)), dhs.vector(b))
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        last = float(rs.res[rs.n_iters])
        smoothers[name] = {"cycles": rs.n_iters, "res": last,
                           "stalled": rs.stalled,
                           "ms_per_cycle": s / max(1, rs.n_iters) * 1e3}
        print(f"  {name:8s}: {rs.n_iters:2d} V-cycles to {last:.3e}"
              f"{' (stalled)' if rs.stalled else ''}, "
              f"{smoothers[name]['ms_per_cycle']:.1f} ms a cycle", flush=True)
        if not np.isfinite(rs.res[:rs.n_iters + 1]).all():
            raise AssertionError(f"{name}: non-finite residual {rs.res}")
        del dhs, rs
    by_path["smoothers"] = dict(kernels.LAUNCHES)
    require_launches("smoothers", by_path["smoothers"])

    # 3. examples/benchmark_pcg.py: Chebyshev(3) in float32. The plain
    # solvers run on the float64 operator: in float32 plain CG does not
    # reach 1e-5 at 512^2 within 20,000 iterations (its float32 run is
    # printed, not held to the tolerance)
    ml.relax_type, ml.num_smooth_sweeps = RelaxType.Chebyshev, 3
    dhc = DeviceHierarchy(ml, dtype=torch.float32)
    pre = dhc.precond_pack()
    A64 = dpar.device_put_matrix(ml.levels[0].A, dtype=torch.float64,
                                 lane_pad=dhc.lane_pad, need_transpose=False)
    f32 = (dhc.levels[0].A, dhc.vector(np.zeros(n)), dhc.vector(b))
    f64 = (A64,) + tuple(
        dpar.device_put_vector(v, ml.levels[0].A.partition.row_bounds,
                               A64.rows_pad, dtype=torch.float64)
        for v in (np.zeros(n), b))
    # (name, solver, operator and vectors, tolerance, cap, held to it,
    # other arguments)
    runs = (("CG (float64)", cg, f64, 1e-5, 20000, True, {}),
            ("CG (float32)", cg, f32, 1e-5, 20000, False, {}),
            ("BiCGStab (float64)", bicgstab, f64, 1e-5, 20000, True, {}),
            ("AMG-PCG", cg, f32, 1e-5, 200, True, {"precond": pre}),
            ("Pre-BiCGStab", bicgstab, f32, 1e-5, 200, True,
             {"precond": pre}),
            ("AMG-GMRES(30)", gmres, f32, 1e-5, 200, True,
             {"precond": pre, "restart": 30}),
            ("f64 CG, f32 AMG", cg, f64, 1e-11, 200, True,
             {"precond": pre}))
    krylov = {}
    kernels.reset_launches()
    for name, fn, args, tol, cap, held, kw in runs:
        t0 = time.perf_counter()
        rk = fn(*args, tol=tol, max_iter=cap, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        # CG and GMRES hold ||r|| / ||b||, BiCGStab ||r||; x0 = 0
        rel = float(rk.res[rk.n_iters] / rk.res[0])
        krylov[name] = {"iters": rk.n_iters, "rel_res": rel, "s": s,
                        "ms_per_iter": s / max(1, rk.n_iters) * 1e3,
                        "held": held}
        print(f"  {name:18s}: {rk.n_iters:5d} iterations to {rel:.3e} in "
              f"{s:.3f} s, {krylov[name]['ms_per_iter']:.3f} ms an "
              f"iteration{'' if held else ' (not held to 1e-5)'}",
              flush=True)
        if held and (not rel <= tol or rk.x.dtype != args[2].dtype
                     or not torch.isfinite(rk.x).all()):
            raise AssertionError(f"{name}: no {tol} within {cap}: {rel}")
    by_path["krylov"] = dict(kernels.LAUNCHES)
    require_launches("Krylov runs", by_path["krylov"])
    profile = profile_krylov(torch, dhc, f32[2], krylov["AMG-PCG"]["iters"],
                             krylov["AMG-PCG"]["ms_per_iter"])
    return {"nk": nk, "levels": ml.num_levels, "setup_s": setup_s,
            "pack_s": pack_s, "fwd_levels": fwd, "bwd_levels": bwd,
            "sor_cycles": k, "sor_res": sor_res, "sor_solve_s": solve_s,
            "sor_vcycle_ms": cycle_ms, "sor_vcycle_enqueue_ms": enqueue_ms,
            "sor_vcycle_kernels": n_kern, "sor_vcycle_busy_ms": busy_ms,
            "launches_per_sor_vcycle": per_cycle, "smoothers": smoothers,
            "krylov": krylov, "profile": profile}


def path_kernels(dh, residual=True):
    """The kernels the solve of this hierarchy launches: one per format of
    its operators, and (``residual``) DIA for the float64 residual of the
    stencil A."""
    fmts = {"dia"} if residual else set()
    for lvl in dh.levels:
        fmts |= {m.on_format for m in (lvl.A, lvl.P, lvl.Pt) if m is not None}
    return sorted(FORMAT_KERNEL[f] for f in fmts if f in FORMAT_KERNEL)


def drive_solve(torch, dh, A, b, what, kernels, limit=None):
    """Mixed-precision refinement to 1e-8 from zero, with the launch counts
    of exactly this run; fails when a kernel of the path did not run."""
    n = A.global_num_rows
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, hist = dh.solve_mixed(np.zeros(n), b, tol=1e-8, max_iter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    relres = float(np.linalg.norm(b - A.mult(x)) / np.linalg.norm(b))
    k = len(hist) - 1
    print(f"solve ({what}): {k} refinements to {hist[-1]:.3e} "
          f"(host-recomputed {relres:.3e}) in {solve_s:.3f} s, first call; "
          f"launches {launches}", flush=True)
    if not (np.isfinite(x).all() and x.shape == (n,)):
        raise AssertionError("solution is not finite or has the wrong shape")
    if hist[-1] > 1e-8 or relres > 1e-8 or (limit is not None and k > limit):
        raise AssertionError(f"{what}: no 1e-8 within {limit}: {hist}")
    require_launches(what, launches, path_kernels(dh))
    return k, launches, solve_s


def cycle_report(torch, dh, b, kernels):
    """One f32 V-cycle: launches per kernel, device ms by CUDA events, host
    enqueue ms, per-level ms and the profiler's busy share."""
    n = len(b)
    xd = dh.vector(np.zeros(n))
    bd = dh.vector(b / np.linalg.norm(b))
    kernels.reset_launches()
    dh.vcycle(xd, bd)
    torch.cuda.synchronize()
    per_cycle = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    dh.vcycle(xd, bd)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    cycle_ms = time_ms(torch, lambda: dh.vcycle(xd, bd), reps=10)
    lv = level_times(torch, dh)
    n_kern, busy_ms = device_busy(torch, lambda: dh.vcycle(xd, bd))
    busy = (f"{n_kern} kernels, {busy_ms:.3f} ms busy = "
            f"{busy_ms / cycle_ms:.1%} of the cycle" if n_kern
            else "device busy share not measured (no profiler trace)")
    print(f"V-cycle (float32): {cycle_ms:.3f} ms on the card, host enqueue "
          f"{enqueue_ms:.3f} ms; {busy}; ported-kernel launches per cycle "
          f"{per_cycle}")
    for i, t in enumerate(lv):
        print(f"  level {i:2d}: {dh.levels[i].A.global_num_rows:8d} rows "
              f"{t:8.4f} ms")
    print(f"  sum of levels {sum(lv):.3f} ms", flush=True)
    return {"vcycle_ms": cycle_ms, "vcycle_enqueue_ms": enqueue_ms,
            "vcycle_kernels": n_kern, "vcycle_busy_ms": busy_ms,
            "level_ms": lv, "launches_per_vcycle": per_cycle}


def slice_seconds(M):
    """Host seconds of ``formats.well_slices`` on the packed windowed-ELL
    arrays of ``M``, run once more: the share of its pack that the sliced
    layout adds (``device_put_matrix`` runs it inside the pack)."""
    from raptor_tpu_torch.device.formats import well_slices
    arrays = [t.cpu().numpy() for t in (M.wl_ws, M.on_cols, M.on_vals)]
    t0 = time.perf_counter()
    well_slices(*arrays, M.wl_ba, M.wl_wr)
    return time.perf_counter() - t0


def transfer_formats(torch, ml, lane_pad, kernels, seed):
    """Level-0 P (embedded by columns) and P^T (by rows) in the automatic
    and in each forced format, as the JAX package's shoot-out packs them
    (bench.py:383-426): each packed, applied once and checked against the
    host product, with the launch counts of that path. Returns the packed
    operators and the counts."""
    from raptor_tpu_torch.device import par as dpar
    P = ml.levels[0].P
    plan = (("P0", P, "cols", (None, "well", "bell", "ell")),
            ("Pt0", P.transpose(), "rows",
             (None, "well", "wellt", "bell", "ell")))
    rng = np.random.default_rng(seed)
    packed = []
    kernels.reset_launches()
    for label, host, embed, forced in plan:
        xh = rng.random(host.global_num_cols)
        ref = host.mult(xh)
        for f in forced:
            t0 = time.perf_counter()
            M = dpar.device_put_matrix(host, dtype=torch.float32,
                                       lane_pad=lane_pad, embed=embed,
                                       force_format=f, need_transpose=False)
            pack_s = time.perf_counter() - t0
            x = dpar.device_put_vector(xh, host.partition.col_bounds,
                                       M.cols_pad, dtype=torch.float32)
            y = dpar.host_vector(dpar.spmv(M, x), host.partition.row_bounds)
            err = float(np.abs(y - ref).max() / np.abs(ref).max())
            if not err <= TOL["float32"]:
                raise AssertionError(f"{label} {f or 'auto'} "
                                     f"({M.on_format}): rel err {err}")
            slice_s = slice_seconds(M) if M.on_format == "well" else None
            packed.append((label, f or "auto", M, host, embed, x, err,
                           pack_s, slice_s))
    launches = dict(kernels.LAUNCHES)
    for name in ("wind_ell_spmv", "swellt_spmv_T", "bell_spmv"):
        if launches[name] == 0:
            raise AssertionError(f"transfer path: {name} did not run "
                                 f"({launches})")
    return packed, launches


def time_transfer(torch, packed, gen):
    """Each packed operator's SpMV time beside its byte bound and
    torch.sparse, both timed back to back (``kernel_ms``)."""
    from raptor_tpu_torch.device.par import spmv
    rows = []
    for label, f, M, host, _, x, err, pack_s, slice_s in packed:
        isz = M.on_vals.element_size()
        nbytes = (needed_bytes(M)
                  + M.n_shards * (x.shape[1] + M.rows_pad) * isz)
        ms = kernel_ms(torch, lambda M=M, x=x: spmv(M, x))
        lib = torch_sparse(torch, host, M.dtype, gen)
        bound_ms, _ = bound(nbytes, 0, "float32")
        rows.append({"operator": label, "forced": f, "format": M.on_format,
                     "embed": M.embed_kind, "ms": ms, "bound_ms": bound_ms,
                     "library_ms": lib, "bytes": int(nbytes),
                     "rel_err": err, "pack_s": pack_s, "slice_s": slice_s})
        sliced = ("" if slice_s is None else
                  f" (slicing {slice_s:.2f} s of it, timed again)")
        print(f"  {label} {f:5s} -> {M.on_format:5s}/{M.embed_kind:4s}: "
              f"spmv {ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B), "
              f"torch.sparse {lib:.4f} ms, rel err {err:.2e}, packed in "
              f"{pack_s:.2f} s{sliced}", flush=True)
    return rows


# phase 13: the setups that run the device engines ("auto" on the card).
# RS solves (b = A 1, float32, to 1e-8) must take at most CARD_RS_CAP
# refinements; SA at most the JAX package's count + CARD_SA_SLACK, the
# spread between the engines that tests/test_device_interp.py allows; a
# replayed level's values must be within REPLAY_TOL of max |host| (float64).
# The 3-D setup runs at --card-n3 (80^3, cut to make room for phase 21;
# 96^3 before it, cut for phase 19 from phase 6's --n3, 128^3):
# its levels 0 and 1 stay above the device engines' gate. RS holds no count
# of the JAX package here, only the cap.
CARD_RS_CAP = 20
CARD_SA_SLACK = 2
REPLAY_TOL = 1e-12


@contextlib.contextmanager
def interp_inputs(record):
    """Record (A, S, CF states, kind, P, seconds) of every
    ``par_interpolation`` call of a setup: P before ``filter_interp``, so
    that each level's interpolation can be replayed on exactly its inputs
    and held to exactly its output."""
    from raptor_tpu_torch.multilevel import par_multilevel as pm
    real = pm.par_interpolation

    def spy(a, s, states, kind, *args):
        t0 = time.perf_counter()
        p = real(a, s, states, kind, *args)
        record.append((a, s, np.asarray(states), kind, p,
                       time.perf_counter() - t0))
        return p

    pm.par_interpolation = spy
    try:
        yield
    finally:
        pm.par_interpolation = real


def replay_error(what, dev, host, tol=REPLAY_TOL):
    """max |dev - host| / max |host| of two CSRs with the same pattern;
    fails when the patterns differ or the error passes ``tol``."""
    if dev.shape != host.shape or not (
            np.array_equal(dev.indptr, host.indptr)
            and np.array_equal(dev.indices, host.indices)):
        raise AssertionError(f"{what}: the device engine's pattern is not "
                             f"the host engine's")
    if host.nnz == 0:
        return 0.0
    err = float(np.abs(dev.data - host.data).max()
                / np.abs(host.data).max())
    if err > tol:
        raise AssertionError(f"{what}: device values {err:.3e} of max "
                             f"|host| from the host engine's")
    return err


def replay_levels(ml, record, what):
    """Every level that ran a device engine, computed again by the host
    engine on the same inputs: interpolation on (A, S, CF states), held to
    the device engine's P before the filter, and the Galerkin product on
    (A, P), held to the setup's coarse operator. Returns one row per level
    with both engines' seconds (the device engine's from the setup)."""
    from raptor_tpu_torch.ruge_stuben import interpolation as itp
    rap_s = {lvl: sec for lvl, _, sec in ml.rap_stats}
    rows = []
    for i, eng in enumerate(ml.level_engines[:ml.num_levels - 1]):
        row = {"level": i, "rows": ml.levels[i].A.global_num_rows,
               "nnz": ml.levels[i].A.nnz, **eng}
        if eng.get("interp") == "device":
            a, s, states, kind, pd, row["interp_device_s"] = record[i]
            t0 = time.perf_counter()
            ph = itp._KINDS[kind](a.global_csr, s.global_csr, states)
            row["interp_host_s"] = time.perf_counter() - t0
            row["interp_err"] = replay_error(
                f"{what} level {i} interpolation", pd.global_csr, ph)
        if eng.get("rap") == "device":
            a, p = ml.levels[i].A.global_csr, ml.levels[i].P.global_csr
            t0 = time.perf_counter()
            ac = p.T_multiply(a.multiply(p))
            row["rap_host_s"] = time.perf_counter() - t0
            row["rap_device_s"] = rap_s[i]
            row["rap_err"] = replay_error(f"{what} level {i} RAP",
                                          ml.levels[i + 1].A.global_csr, ac)
        print(f"  replay level {i}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "level"), flush=True)
        rows.append(row)
    return rows


def card_setup(torch, what, setup, size, host, kernels, by_path, key,
               limit):
    """Phase 13 for one configuration: ``setup(size, "auto")`` on the
    card, the engine of each level (every level at or above the gate on
    the device engine), its phase split beside the host-engine setup's
    (``host``: that phase's summary), the per-level replay and the
    float32 solve with b = A 1 in at most ``limit`` refinements. Returns
    (summary, setup)."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.ruge_stuben.interpolation import DEVICE_MIN_NNZ
    record = []
    t0 = time.perf_counter()
    with interp_inputs(record):
        A, ml = setup(size, "auto")
    setup_s = time.perf_counter() - t0
    print(ml.print_hierarchy())
    print(ml.print_setup_times())
    phases = dict(ml.setup_times.times)
    print(f"{what} setup on the card: {ml.num_levels} levels in "
          f"{setup_s:.3f} s (host engines, side {host['size']}: "
          f"{host['levels']} levels in {host['setup_s']:.3f} s)")
    print(f"  phases, card engines {json.dumps(phases)}")
    print(f"  phases, host engines {json.dumps(host['setup_phase_totals'])}")
    print(f"  engines by level {ml.level_engines}", flush=True)
    for i, eng in enumerate(ml.level_engines[:ml.num_levels - 1]):
        if ml.levels[i].A.nnz >= DEVICE_MIN_NNZ and any(
                v != "device" for k, v in eng.items()
                if not k.endswith("_reason")):
            raise AssertionError(f"{what} level {i} ({ml.levels[i].A.nnz} "
                                 f"nonzeros) is at or above the gate and "
                                 f"did not run the device engines: {eng}")
    rows = replay_levels(ml, record, what)
    del record
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float32)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    b = A.mult(np.ones(A.global_num_rows))
    k, by_path[key], solve_s = drive_solve(torch, dh, A, b,
                                           f"{what}, card setup, b = A 1",
                                           kernels, limit=limit)
    print(f"  refinements: {k} (host-engine setup: "
          f"{host['solve_refinements_ones']}, cap {limit})", flush=True)
    del dh
    torch.cuda.empty_cache()
    return ({"size": size, "levels": ml.num_levels, "setup_s": setup_s,
             "setup_phase_totals": phases,
             "host_setup_s": host["setup_s"],
             "host_setup_phase_totals": host["setup_phase_totals"],
             "level_engines": ml.level_engines, "replay": rows,
             "pack_s": pack_s, "solve_refinements_ones": k,
             "host_solve_refinements_ones": host["solve_refinements_ones"],
             "solve_s_first": solve_s}, ml)


def rap_again(torch, ml):
    """A second device Galerkin product of level 0, traced by
    torch.profiler: it must be bytes-equal to the setup's coarse operator.
    Returns its wall seconds (profiler on), the summed ms of the kernels
    it ran and their count."""
    from torch.profiler import ProfilerActivity, profile
    from raptor_tpu_torch.device import spgemm as dsp
    a, p = ml.levels[0].A.global_csr, ml.levels[0].P.global_csr
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ac, _ = dsp.rap_device(a, p, need_ap=False, device="cuda")
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    kern = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    first = ml.levels[1].A.global_csr
    if not (np.array_equal(ac.indptr, first.indptr)
            and np.array_equal(ac.indices, first.indices)
            and ac.data.tobytes() == first.data.tobytes()):
        raise AssertionError("two device Galerkin products of level 0 "
                             "differ")
    busy = (f"{len(kern)} kernels, {sum(kern):.1f} ms busy = "
            f"{sum(kern) / 1e3 / sec:.1%} of it" if kern
            else "device busy share not measured (no profiler trace)")
    print(f"  level-0 device RAP again: bytes-equal, {sec:.3f} s with the "
          f"profiler on; {busy}", flush=True)
    return {"rap_again_s": sec, "rap_again_kernels": len(kern),
            "rap_again_busy_ms": sum(kern)}


def setup_on_card(torch, n, n3, n_sa, host, kernels, by_path):
    """Phase 13 (see the module docstring) with the 2-D configuration at
    n^2; ``host`` holds the summaries of phases 6, 3 and 11's side
    ``n_sa``."""
    out = {}
    out["3d"], ml = card_setup(torch, f"3-D {n3}^3", lap27_setup, n3,
                               host["3d"], kernels, by_path,
                               "card_setup_3d_solve", CARD_RS_CAP)
    out["3d"].update(rap_again(torch, ml))
    del ml
    out["2d"], _ = card_setup(torch, f"2-D {n}^2", aniso_setup, n,
                              host["2d"], kernels, by_path,
                              "card_setup_2d_solve", CARD_RS_CAP)
    sa_cap = (SA_REFINEMENTS[n_sa] + CARD_SA_SLACK
              if n_sa in SA_REFINEMENTS else None)
    out["sa"], _ = card_setup(torch, f"SA {n_sa}^3", sa_setup, n_sa,
                              host["sa"], kernels, by_path,
                              "card_setup_sa_solve", sa_cap)
    return out


# phase 14: the topology-aware exchange (TAP) and the distributed setup, on
# the 8 shards of TAP_LAYOUT (hosts x shards per host, the JAX package's
# multichip record). The JAX package's level sizes (HMIS + extended+i,
# theta 0.25, host engines), from a CPU run of the JAX package:
#   JAX_PLATFORMS=cpu python -c "import sys, numpy as np; from \
#   raptor_tpu.core.types import CoarsenType as C, InterpType as I; from \
#   raptor_tpu.gallery.stencils import diffusion_stencil_2d as D, \
#   par_stencil_grid as G; from raptor_tpu.multilevel.par_multilevel \
#   import ParRugeStubenSolver as RS; n, mode = int(sys.argv[1]), \
#   sys.argv[2]; ml = RS(0.25, C.HMIS, I.Extended); ml.rap_mode = \
#   ml.interp_mode = 'host'; ml.setup_mode = mode; ml.setup(G(D(0.001, \
#   np.pi / 8), (n, n), 8)); print([l.A.global_num_rows for l in \
#   ml.levels])" N MODE
TAP_LAYOUT = (2, 4)
TAP_N = 512           # 14a: examples/benchmark_tap_amg.py's grid side
TAP_LEVELS = [262144, 131072, 65536, 21308, 6783, 2052, 750, 204, 52,
              18]                                           # global, 14a
DIST_LEVELS = {1024: [1048576, 524288, 262144, 86479, 26951, 8091, 2836,
                      662, 144, 29],
               512: [262144, 131072, 65536, 20948, 6288, 1730, 379, 87,
                     20]}                                   # distributed, 14b
TAP_TOL = 1e-6        # examples/benchmark_tap_amg.py's solve_tol
# 14a: the JAX package's V-cycles to TAP_TOL at TAP_N^2 (TAP on every
# level, a float32 hierarchy refined with float64 residuals), the most
# the port may take plus one (SOR's atomics); the command prints them
# after the cycles, stall flag and last residual of its float32
# ``solve``, which stalls above TAP_TOL:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#   python -c "import numpy as np, jax; jax.config.update( \
#   'jax_enable_x64', True); import jax.numpy as jnp; from \
#   raptor_tpu.core.types import CoarsenType as C, InterpType as I, \
#   RelaxType as R; from raptor_tpu.device.par import make_mesh2; from \
#   raptor_tpu.gallery.stencils import diffusion_stencil_2d as D, \
#   par_stencil_grid as G; from raptor_tpu.multilevel.device_hierarchy \
#   import DeviceHierarchy as DH; from raptor_tpu.multilevel.par_multilevel \
#   import ParRugeStubenSolver as RS; A = G(D(0.001, np.pi / 8), (512, \
#   512), 8); ml = RS(0.25, C.HMIS, I.Extended, relax_type=R.SOR); \
#   ml.rap_mode = ml.interp_mode = 'host'; ml.setup(A); ml.tap_amg = 0; \
#   ml.solve_tol = 1e-6; b = A.mult(np.ones(512 ** 2)); dh = DH(ml, \
#   make_mesh2(2, 4), dtype=jnp.float32); r = dh.solve(dh.vector(0 * b), \
#   dh.vector(b)); k = int(r.n_iters); _, h = dh.solve_mixed(0 * b, b, \
#   tol=1e-6); print(k, bool(r.stalled), float(r.res[k]), len(h) - 1)"
TAP_CYCLES = 17
CARD_CPU_TOL = 1e-12  # 14c: card against CPU, of max |x|


def tap_setup(n, mode, relax, sweeps):
    """Phase 14's host setup: n x n rotated anisotropic diffusion on the
    shards of TAP_LAYOUT, HMIS + extended+i, theta 0.25, host engines, in
    ``setup_mode`` ``mode``; returns (A, setup, seconds)."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    H, L = TAP_LAYOUT
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         H * L)
    ml = ParRugeStubenSolver(0.25, CoarsenType.HMIS, InterpType.Extended,
                             relax_type=getattr(RelaxType, relax))
    ml.num_smooth_sweeps = sweeps
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup_mode = mode
    t0 = time.perf_counter()
    ml.setup(A)
    return A, ml, time.perf_counter() - t0


def level_sizes(what, ml, want):
    """The hierarchy's level sizes; fails when they are not ``want`` (the
    JAX package's, where known)."""
    got = [lvl.A.global_num_rows for lvl in ml.levels]
    if want is not None and got != want:
        raise AssertionError(f"{what}: levels {got}, the JAX package's "
                             f"{want}")
    return got


def tap_hierarchy(ml, tap_amg, dtype, device="cuda"):
    """The device hierarchy on TAP_LAYOUT with TAP from level ``tap_amg``
    (-1: the plain exchange throughout), with the card's 128-lane
    padding on either device."""
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    ml.tap_amg = tap_amg
    return DeviceHierarchy(ml, dtype=dtype, lane_pad=128, device=device,
                           mesh=make_mesh2(*TAP_LAYOUT))


def dcn_report(ml):
    """Per level, the values that cross hosts under the TAP plans of A, P
    and P^T beside the plain exchange's (the plans' ``dcn_values`` and
    ``dcn_values_plain``); fails when TAP sends more."""
    from raptor_tpu_torch.comm.tap import build_tap_plan
    rows = []
    for i, lvl in enumerate(ml.levels):
        mats = [("A", lvl.A)]
        if lvl.P is not None:
            mats += [("P", lvl.P), ("Pt", lvl.P.transpose())]
        row = {}
        for name, m in mats:
            plan = build_tap_plan(m, *TAP_LAYOUT)
            row[name] = [plan.dcn_values, plan.dcn_values_plain]
            if plan.dcn_values > plan.dcn_values_plain:
                raise AssertionError(f"level {i} {name}: TAP sends "
                                     f"{plan.dcn_values} values across "
                                     f"hosts, the plain exchange "
                                     f"{plan.dcn_values_plain}")
        print(f"  level {i}: " + ", ".join(
            f"{k} dcn {v[0]} (plain {v[1]})" for k, v in row.items()))
        rows.append(row)
    return rows


def compare_cycles(torch, dhs, b, kernels, rounds=3):
    """One V-cycle of each hierarchy of ``dhs`` (label -> hierarchy): the
    ported kernels' launches, then device ms (CUDA events, 5 cycles) and
    host enqueue ms taken in turns, one hierarchy after the other for
    ``rounds`` rounds (the host's load drifts), their medians and ranges,
    and last the profiler's kernel count and busy ms of each."""
    xd = {k: dh.vector(np.zeros_like(b)) for k, dh in dhs.items()}
    bd = {k: dh.vector(b / np.linalg.norm(b)) for k, dh in dhs.items()}

    def cycle(k):
        return lambda: dhs[k].vcycle(xd[k], bd[k])

    out = {k: {"vcycle_ms_rounds": [], "vcycle_enqueue_ms_rounds": []}
           for k in dhs}
    for k in dhs:
        kernels.reset_launches()
        cycle(k)()
        torch.cuda.synchronize()
        out[k]["launches_per_vcycle"] = dict(kernels.LAUNCHES)
    for _ in range(rounds):
        for k in dhs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cycle(k)()
            out[k]["vcycle_enqueue_ms_rounds"].append(
                (time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            out[k]["vcycle_ms_rounds"].append(
                time_ms(torch, cycle(k), reps=5, warm=1))
    for k in dhs:
        c = out[k]
        c["vcycle_ms"] = statistics.median(c["vcycle_ms_rounds"])
        c["vcycle_enqueue_ms"] = statistics.median(
            c["vcycle_enqueue_ms_rounds"])
        c["vcycle_kernels"], c["vcycle_busy_ms"] = device_busy(torch,
                                                               cycle(k))
    return out


def print_cycles(what, cycles):
    for label, c in cycles.items():
        busy = (f"{c['vcycle_kernels']} kernels busy "
                f"{c['vcycle_busy_ms']:.3f} ms" if c["vcycle_kernels"]
                else "busy not measured (no profiler trace)")
        print(f"  {what} V-cycle, {label}: {c['vcycle_ms']:.3f} ms on the "
              f"card (rounds {[round(t, 3) for t in c['vcycle_ms_rounds']]}"
              f"), enqueue {c['vcycle_enqueue_ms']:.3f} ms (rounds "
              f"{[round(t, 3) for t in c['vcycle_enqueue_ms_rounds']]}), "
              f"{busy}; ported-kernel launches "
              f"{c['launches_per_vcycle']}", flush=True)


def tap_example(torch, kernels, by_path):
    """14a: examples/benchmark_tap_amg.py at side TAP_N (global setup,
    SOR(1), float32 V-cycles, b = A 1, to TAP_TOL) with the plain
    exchange, TAP on every level and TAP from level 1; the same V-cycles
    to within one (SOR's index_add_ sums with atomics on the card), at
    most the JAX package's (TAP_CYCLES) + 1. The residual is taken in
    float64 (``solve_mixed``, one V-cycle a refinement): the float32
    residual of ``solve`` levels off above TAP_TOL at TAP_N^2."""
    n = TAP_N
    A, ml, setup_s = tap_setup(n, "global", "SOR", 1)
    levels = level_sizes(f"TAP {n}^2", ml, TAP_LEVELS)
    print(f"TAP example {n}^2 on {TAP_LAYOUT[0]} x {TAP_LAYOUT[1]} shards: "
          f"levels {levels}, setup {setup_s:.3f} s")
    b = A.mult(np.ones(A.global_num_rows))
    runs, xs, kept = {}, {}, {}
    for label, tap_amg in (("plain", -1), ("tap0", 0), ("tap1", 1)):
        t0 = time.perf_counter()
        dh = tap_hierarchy(ml, tap_amg, torch.float32)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        xs[label], hist = dh.solve_mixed(np.zeros_like(b), b, tol=TAP_TOL,
                                         max_iter=100)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        by_path[f"tap{n}_{label}"] = launches
        k = len(hist) - 1
        print(f"  {label}: {k} V-cycles to {hist[-1]:.3e} in {solve_s:.3f} "
              f"s (pack {pack_s:.3f} s); launches {launches}", flush=True)
        if hist[-1] > TAP_TOL or not np.isfinite(xs[label]).all():
            raise AssertionError(f"TAP {n}^2 {label}: no {TAP_TOL} ({hist})")
        require_launches(f"TAP {n}^2 {label}", launches, path_kernels(dh))
        require_launches(f"TAP {n}^2 {label}", launches)
        runs[label] = {"vcycles": k, "final_res": float(hist[-1]),
                       "solve_s": solve_s, "pack_s": pack_s}
        if label != "tap1":
            kept[label] = dh
        del dh
    counts = [v["vcycles"] for v in runs.values()]
    if max(counts) - min(counts) > 1 or max(counts) > TAP_CYCLES + 1:
        raise AssertionError(f"TAP {n}^2: V-cycles {counts} differ by more "
                             f"than one or pass the JAX package's "
                             f"{TAP_CYCLES} + 1")
    scale = np.abs(xs["plain"]).max()
    for label in ("tap0", "tap1"):
        runs[label]["x_rel_diff"] = float(
            np.abs(xs[label] - xs["plain"]).max() / scale)
        print(f"  max |x_{label} - x_plain| / max |x_plain| = "
              f"{runs[label]['x_rel_diff']:.3e}")
    cycles = compare_cycles(torch, kept, b, kernels)
    del kept
    print_cycles(f"TAP {n}^2", cycles)
    print("  values across hosts per level (TAP plans vs plain exchange):")
    dcn = dcn_report(ml)
    return {"n": n, "levels": levels, "setup_s": setup_s, "runs": runs,
            "cycles": cycles, "dcn": dcn}


def dist_flagship(torch, n, kernels, by_path):
    """14b: the flagship at side n with the distributed setup on
    TAP_LAYOUT, Chebyshev(3), float32, TAP on every level, refined to 1e-8
    with b = A 1 in at most 20 refinements, equal to the plain exchange's
    on the same hierarchy; the setup's phase split beside the global
    setup's of the same problem. Returns (summary, A, the setup), which
    phase 15 reuses."""
    A, ml, setup_s = tap_setup(n, "distributed", "Chebyshev", 3)
    levels = level_sizes(f"distributed {n}^2", ml, DIST_LEVELS.get(n))
    print(f"distributed setup {n}^2 on {TAP_LAYOUT[0] * TAP_LAYOUT[1]} "
          f"shards: levels {levels} in {setup_s:.3f} s")
    print(ml.print_setup_times())
    _, mlg, global_s = tap_setup(n, "global", "Chebyshev", 3)
    global_levels = [lvl.A.global_num_rows for lvl in mlg.levels]
    global_phases = dict(mlg.setup_times.times)
    del mlg
    print(f"  global setup of the same problem: {len(global_levels)} levels "
          f"in {global_s:.3f} s, phases {json.dumps(global_phases)}")
    b = A.mult(np.ones(A.global_num_rows))
    out = {"n": n, "levels": levels, "setup_s": setup_s,
           "setup_phase_totals": dict(ml.setup_times.times),
           "setup_level_times": ml.setup_level_times,
           "global_setup_s": global_s, "global_levels": global_levels,
           "global_setup_phase_totals": global_phases}
    kept = {}
    for label, tap_amg in (("tap0", 0), ("plain", -1)):
        t0 = time.perf_counter()
        kept[label] = tap_hierarchy(ml, tap_amg, torch.float32)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        key = f"dist{n}_{label}"
        k, by_path[key], solve_s = drive_solve(
            torch, kept[label], A, b, f"distributed {n}^2, {label}",
            kernels, limit=CARD_RS_CAP)
        if tap_amg == 0:
            require_launches(f"distributed {n}^2 TAP", by_path[key])
        out[label] = {"refinements": k, "solve_s_first": solve_s,
                      "pack_s": pack_s}
    for label, c in compare_cycles(torch, kept, b, kernels).items():
        out[label].update(c)
    del kept
    torch.cuda.empty_cache()
    if out["tap0"]["refinements"] != out["plain"]["refinements"]:
        raise AssertionError(f"distributed {n}^2: TAP takes "
                             f"{out['tap0']['refinements']} refinements, "
                             f"the plain exchange "
                             f"{out['plain']['refinements']}")
    print_cycles(f"distributed {n}^2",
                 {k: out[k] for k in ("tap0", "plain")})
    return out, A, ml


def tap_reference_check(torch, n=64):
    """14c: one float64 TAP V-cycle of a small distributed hierarchy on the
    card and with the plain versions on the CPU; they must agree to
    CARD_CPU_TOL of max |x|."""
    A, ml, _ = tap_setup(n, "distributed", "Chebyshev", 3)
    b = A.mult(np.ones(A.global_num_rows))
    out = []
    for dev in ("cuda", "cpu"):
        dh = tap_hierarchy(ml, 0, torch.float64, device=dev)
        out.append(dh.host(dh.vcycle(dh.vector(np.zeros_like(b)),
                                     dh.vector(b))))
    err = float(np.abs(out[0] - out[1]).max() / np.abs(out[1]).max())
    print(f"reference: {n}^2 distributed, one float64 TAP V-cycle, card "
          f"against CPU {err:.3e} of max |x|")
    if not err <= CARD_CPU_TOL:
        raise AssertionError(f"TAP V-cycle: card and CPU differ by {err}")
    return err


# phase 15: the distributed SA and blocked setups and the SPMD bridge, on
# 8 stacked shards (4 for the blocked problem, whose shards must hold whole
# nodes), the host engines. 15b: the JAX package's distributed SA level
# sizes at 64^3 on 8 shards and its refinements to 1e-8 (float32
# Chebyshev(2), b = A 1; the port may take one more), from a CPU run of
# the JAX package:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#   python -c "import sys, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.aggregation.solver import ParSmoothedAggregationSolver \
#   as SA; from raptor_tpu.core.types import RelaxType; from \
#   raptor_tpu.device.par import make_mesh; from raptor_tpu.gallery.stencils \
#   import laplace_stencil_27pt as L, par_stencil_grid as G; from \
#   raptor_tpu.multilevel.device_hierarchy import DeviceHierarchy as DH; \
#   n = int(sys.argv[1]); A = G(L(), (n,) * 3, 8); ml = SA(0.0, \
#   relax_type=RelaxType.Chebyshev); ml.num_smooth_sweeps = 2; \
#   ml.setup_mode = 'distributed'; ml.setup(A); b = A.mult(np.ones(n ** 3)); \
#   _, h = DH(ml, make_mesh(8), dtype=jnp.float32).solve_mixed( \
#   np.zeros(n ** 3), b, tol=1e-8, max_iter=200); print([l.A.global_num_rows \
#   for l in ml.levels], len(h) - 1, h[-1])" 64
SPMD_SA_N = 64
SPMD_SA_LEVELS = [262144, 6101, 86, 1]
SPMD_SA_REFINEMENTS = 27
# 15c: the JAX package's distributed blocked level sizes at 128 x 64
# elements on 4 shards (CLJP + modified classical, theta 0.25), its blocked
# V-cycles to 1e-6 and BSR-PCG iterations to 1e-10 (float64, b = A 1,
# block Chebyshev(3)), the most the port may take:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
#   python -c "import sys, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.core.types import CoarsenType as C; from raptor_tpu.device \
#   import par as dp; from raptor_tpu.gallery.fem import par_fem; from \
#   raptor_tpu.krylov.cg import cg; from raptor_tpu.multilevel.bsr_hierarchy \
#   import BSRDeviceHierarchy as BDH, ParBSRRugeStubenSolver as BRS; \
#   nx, ny = int(sys.argv[1]), int(sys.argv[2]); A, _ = par_fem('elasticity', \
#   nx, ny, 4); ml = BRS(2, 0.25, coarsen_type=C.CLJP); ml.setup_mode = \
#   'distributed'; ml.setup(A); m = dp.make_mesh(4); dh = BDH(ml, m, \
#   sweeps=3); b = A.mult(np.ones(A.global_num_rows)); _, h, k = dh.solve( \
#   dh.vector(0 * b), dh.vector(b), tol=1e-6, max_iter=100); Ab = \
#   ml.levels[0].A; dA = dp.device_put_matrix(Ab, m, dtype=jnp.float64, \
#   need_transpose=False); v = lambda y: dp.device_put_vector(y, \
#   Ab.partition.row_bounds, dA.rows_pad, m); r = cg(m, dA, v(0 * b), v(b), \
#   tol=1e-10, max_iter=200, precond=dh.precond_pack()); \
#   print([l.A.global_num_rows for l in ml.levels], int(k), int(r.n_iters))" \
#   128 64
SPMD_BSR = (128, 64)
SPMD_BSR_SHARDS = 4
SPMD_BSR_LEVELS = [16640, 5188, 1894, 764, 302, 110, 42]
SPMD_BSR_CYCLES = 44
SPMD_BSR_PCG = 28
SPMD_CPU_N = 64       # 15d: the card-against-CPU check's side
SPMD_TOL = 1e-12      # 15b / 15c: values of the two setups, relative


def stacked(blocks):
    """Per-shard row blocks (global columns) stacked into one CSR."""
    import scipy.sparse as sp
    from raptor_tpu_torch.core.matrix import CSRMatrix
    g = sp.vstack([b.to_scipy() for b in blocks]).tocsr()
    g.sort_indices()
    return CSRMatrix.from_scipy(g)


def spmd_levels_close(what, refs, gots):
    """Two setups' matrices (CSR), level by level: equal patterns after a
    common 1e-14 drop, values within SPMD_TOL of the level's largest;
    returns the largest relative difference."""
    worst = 0.0
    for i, (r, g) in enumerate(zip(refs, gots)):
        r, g = r.drop(1e-14), g.drop(1e-14)
        if not (np.array_equal(r.indptr, g.indptr)
                and np.array_equal(r.indices, g.indices)):
            raise AssertionError(f"{what}: level {i}'s pattern differs")
        err = float(np.abs(r.data - g.data).max(initial=0.0)
                    / max(np.abs(r.data).max(initial=0.0), 1e-300))
        worst = max(worst, err)
    if len(refs) != len(gots) or not worst <= SPMD_TOL:
        raise AssertionError(f"{what}: {len(gots)} levels against "
                             f"{len(refs)}, values {worst:.3e} apart")
    return worst


def spmd_close(what, ml, hier):
    """A setup_mode="distributed" hierarchy and the SPMD one of the same
    problem: every level's operator and P (``spmd_levels_close``)."""
    return max(
        spmd_levels_close(what, [lvl.A.global_csr for lvl in ml.levels],
                          [lvl.a_local.assemble_global()
                           for lvl in hier.levels]),
        spmd_levels_close(f"{what} P",
                          [lvl.P.global_csr for lvl in ml.levels[:-1]],
                          [stacked(lvl.p_blocks)
                           for lvl in hier.levels[:-1]]))


def spmd_bridge(torch, ml, A, dist, kernels, by_path):
    """15a: the whole-hierarchy per-rank setup of 14b's problem, its level
    sizes those of 14b's setup_mode="distributed" hierarchy (``ml``), packed
    by ``DeviceHierarchy.from_spmd`` with the plain exchange and with TAP
    on every level; each refined to 1e-8 with b = A 1 in 14b's refinements
    (``dist``), vector_local equal to vector. Returns (summary, the
    per-rank hierarchy), which phase 16 holds its controllers to."""
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.comm.transport import InProcessTransport
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    n = dist["n"]
    t0 = time.perf_counter()
    hier = spmd_rs_setup(A, ml.weights, InProcessTransport)
    setup_s = time.perf_counter() - t0
    levels = [lvl.a_local.global_num_rows for lvl in hier.levels]
    print(f"SPMD setup {n}^2 (spmd_rs_setup): levels {levels} in "
          f"{setup_s:.3f} s; setup_mode='distributed' (14b) "
          f"{dist['setup_s']:.3f} s")
    if levels != dist["levels"]:
        raise AssertionError(f"spmd_rs_setup {n}^2: levels {levels}, 14b's "
                             f"{dist['levels']}")
    worst = spmd_close(f"spmd_rs_setup {n}^2", ml, hier)
    b = A.mult(np.ones(A.global_num_rows))
    out = {"n": n, "levels": levels, "setup_s": setup_s,
           "dist_setup_s": dist["setup_s"], "setup_rel_diff": worst}
    kept = {}
    for label, tap_amg in (("plain", -1), ("tap0", 0)):
        t0 = time.perf_counter()
        dh = kept[label] = DeviceHierarchy.from_spmd(
            hier, InProcessTransport, relax_type=RelaxType.Chebyshev,
            num_smooth_sweeps=3, dtype=torch.float32,
            mesh=make_mesh2(*TAP_LAYOUT), tap_amg=tap_amg)
        torch.cuda.synchronize()
        pack_s = time.perf_counter() - t0
        key = f"spmd{n}_{label}"
        k, by_path[key], solve_s = drive_solve(
            torch, dh, A, b, f"SPMD bridge {n}^2, {label}", kernels,
            limit=CARD_RS_CAP)
        require_launches(f"SPMD bridge {n}^2 {label}", by_path[key])
        if k != dist["plain"]["refinements"]:
            raise AssertionError(f"SPMD bridge {n}^2 {label}: {k} "
                                 f"refinements, 14b's "
                                 f"{dist['plain']['refinements']}")
        out[label] = {"refinements": k, "solve_s_first": solve_s,
                      "pack_s": pack_s}
    dh = kept["plain"]
    rb = A.partition.row_bounds
    locs = [b[int(rb[s]):int(rb[s + 1])] for s in range(len(rb) - 1)]
    if not torch.equal(dh.vector_local(locs), dh.vector(b)):
        raise AssertionError("vector_local differs from vector")
    print("\n".join(dh.format_summary()))
    for label, c in compare_cycles(torch, kept, b, kernels).items():
        out[label].update(c)
    print_cycles(f"SPMD bridge {n}^2", {k: out[k] for k in kept})
    # the rows phase 16's controllers print theirs beside
    out["plain"]["profile_rows"] = dh.profile_cycle(reps=PROFILE_REPS)
    return out, hier


def spmd_sa(torch, kernels, by_path):
    """15b: phase 11's smoothed aggregation at SPMD_SA_N^3 on 8 shards:
    setup_mode="distributed" (the JAX package's distributed level sizes),
    then spmd_sa_setup, equal to it level by level, into from_spmd;
    float32 Chebyshev(2) refined to 1e-8 with b = A 1 in at most the JAX
    package's refinements + 1."""
    from raptor_tpu_torch.aggregation.solver import (
        ParSmoothedAggregationSolver)
    from raptor_tpu_torch.comm.spmd import spmd_sa_setup
    from raptor_tpu_torch.comm.transport import InProcessTransport
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        laplace_stencil_27pt, par_stencil_grid)
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    n = SPMD_SA_N
    H, L = TAP_LAYOUT
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), H * L)
    ml = ParSmoothedAggregationSolver(0.0, relax_type=RelaxType.Chebyshev)
    ml.setup_mode = "distributed"
    t0 = time.perf_counter()
    ml.setup(A)
    dist_s = time.perf_counter() - t0
    levels = level_sizes(f"distributed SA {n}^3", ml, SPMD_SA_LEVELS)
    print(ml.print_setup_times())
    t0 = time.perf_counter()
    hier = spmd_sa_setup(A, ml.weights, InProcessTransport, theta=0.0)
    setup_s = time.perf_counter() - t0
    worst = spmd_close(f"spmd_sa_setup {n}^3", ml, hier)
    print(f"SA {n}^3 on {H * L} shards: setup_mode='distributed' levels "
          f"{levels} in {dist_s:.3f} s; spmd_sa_setup {setup_s:.3f} s, "
          f"levels within {worst:.3e}")
    t0 = time.perf_counter()
    dh = DeviceHierarchy.from_spmd(hier, InProcessTransport,
                                   relax_type=RelaxType.Chebyshev,
                                   num_smooth_sweeps=2, dtype=torch.float32)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    print("\n".join(dh.format_summary()))
    b = A.mult(np.ones(n ** 3))
    key = f"spmd_sa{n}"
    k, by_path[key], solve_s = drive_solve(
        torch, dh, A, b, f"SPMD SA {n}^3", kernels,
        limit=SPMD_SA_REFINEMENTS + 1)
    cyc = compare_cycles(torch, {"spmd": dh}, b, kernels)
    print_cycles(f"SPMD SA {n}^3", cyc)
    return {"n": n, "levels": levels, "dist_setup_s": dist_s,
            "setup_phase_totals": dict(ml.setup_times.times),
            "setup_s": setup_s, "setup_rel_diff": worst, "pack_s": pack_s,
            "formats": dh.format_summary(), "refinements": k,
            "jax_refinements": SPMD_SA_REFINEMENTS,
            "solve_s_first": solve_s, **cyc["spmd"]}


def spmd_blocked(torch, kernels, by_path):
    """15c: blocked AMG at SPMD_BSR elements on SPMD_BSR_SHARDS shards,
    CLJP + modified classical, theta 0.25: setup_mode="distributed" (the
    JAX package's distributed level sizes), its blocked float64 V-cycles
    to 1e-6 and BSR-PCG iterations to 1e-10 (at most the JAX package's),
    and spmd_bsr_setup on the block-aligned partition, equal to it level
    by level."""
    from raptor_tpu_torch import (
        BSRDeviceHierarchy, ParBSRRugeStubenSolver, ParCSRMatrix, par_fem)
    from raptor_tpu_torch.comm.spmd import spmd_bsr_setup
    from raptor_tpu_torch.comm.transport import InProcessTransport
    from raptor_tpu_torch.core.types import CoarsenType
    from raptor_tpu_torch.device import par as dpar
    from raptor_tpu_torch.krylov.cg import cg
    from raptor_tpu_torch.multilevel.bsr_hierarchy import block_partition
    nx, ny = SPMD_BSR
    S = SPMD_BSR_SHARDS
    A, _ = par_fem("elasticity", nx, ny, S)
    ml = ParBSRRugeStubenSolver(2, strong_threshold=0.25,
                                coarsen_type=CoarsenType.CLJP)
    ml.setup_mode = "distributed"
    t0 = time.perf_counter()
    ml.setup(A)
    dist_s = time.perf_counter() - t0
    levels = level_sizes(f"distributed BSR {nx} x {ny}", ml, SPMD_BSR_LEVELS)
    part = block_partition(A.global_num_rows, A.global_num_cols, 2, S)
    t0 = time.perf_counter()
    hier = spmd_bsr_setup(ParCSRMatrix(A.global_csr, part), 2, ml.weights,
                          InProcessTransport)
    setup_s = time.perf_counter() - t0
    worst = spmd_close(f"spmd_bsr_setup {nx} x {ny}", ml, hier)
    print(f"blocked {nx} x {ny} on {S} shards: setup_mode='distributed' "
          f"levels {levels} in {dist_s:.3f} s; spmd_bsr_setup "
          f"{setup_s:.3f} s, levels within {worst:.3e}")
    dh = BSRDeviceHierarchy(ml, sweeps=3)
    # sharding changes the shapes, so phase 12's format picks do not hold
    path = bsr_formats(dh, ml, None, None)
    print("\n".join(dh.format_summary()))
    n = A.global_num_rows
    b = A.mult(np.ones(n))
    kernels.reset_launches()
    x, hist, k = dh.solve(dh.vector(np.zeros(n)), dh.vector(b), tol=1e-6,
                          max_iter=100)
    launches = by_path["dist_bsr_solve"] = dict(kernels.LAUNCHES)
    xh = dh.host(x)
    relres = float(np.linalg.norm(b - A.mult(xh)) / np.linalg.norm(b))
    print(f"distributed blocked solve: {k} V-cycles to {hist[k]:.3e} (host "
          f"{relres:.3e}); launches {launches}", flush=True)
    if (hist[k] > 1e-6 or k > SPMD_BSR_CYCLES or relres > 2e-6
            or not np.isfinite(xh).all()):
        raise AssertionError(f"distributed BSR: no 1e-6 within "
                             f"{SPMD_BSR_CYCLES}: {hist[:k + 1]}")
    require_launches("distributed BSR solve", launches, path)
    Ab = ml.levels[0].A
    A64 = dpar.device_put_matrix(Ab, dtype=torch.float64,
                                 lane_pad=dh.lane_pad, need_transpose=False)

    def vec(v):
        return dpar.device_put_vector(v, Ab.partition.row_bounds,
                                      A64.rows_pad, dtype=torch.float64)

    kernels.reset_launches()
    r = cg(A64, vec(np.zeros(n)), vec(b), tol=1e-10, max_iter=200,
           precond=dh.precond_pack())
    by_path["dist_bsr_pcg"] = dict(kernels.LAUNCHES)
    it = r.n_iters
    print(f"distributed BSR-PCG: {it} iterations to {r.res[it]:.3e}",
          flush=True)
    if not r.res[it] <= 1e-10 or it > SPMD_BSR_PCG or r.indefinite:
        raise AssertionError(f"distributed BSR-PCG: no 1e-10 within "
                             f"{SPMD_BSR_PCG}: {r.res[:it + 1]}")
    require_launches("distributed BSR-PCG", by_path["dist_bsr_pcg"],
                     sorted(set(path) | {"dia_spmv"}))
    cyc = bsr_cycle_report(torch, dh, b, kernels)
    return {"nx": nx, "ny": ny, "shards": S, "levels": levels,
            "dist_setup_s": dist_s, "spmd_setup_s": setup_s,
            "setup_rel_diff": worst, "formats": dh.format_summary(),
            "cycles": k, "jax_cycles": SPMD_BSR_CYCLES, "res": float(hist[k]),
            "pcg_iters": it, "jax_pcg_iters": SPMD_BSR_PCG, **cyc}


def spmd_reference_check(torch, n=SPMD_CPU_N):
    """15d: one float64 V-cycle of a from_spmd hierarchy of the n^2
    flagship on TAP_LAYOUT's 8 shards, on the card and with the plain
    versions on the CPU (lane_pad 128 on both): equal to CARD_CPU_TOL of
    max |x|."""
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.comm.transport import InProcessTransport
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
    H, L = TAP_LAYOUT
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                         H * L)
    hier = spmd_rs_setup(A, form_rand_weights(n * n, 0), InProcessTransport)
    b = A.mult(np.ones(n * n))
    out = []
    for dev in ("cuda", "cpu"):
        dh = DeviceHierarchy.from_spmd(
            hier, InProcessTransport, relax_type=RelaxType.Chebyshev,
            num_smooth_sweeps=3, lane_pad=128, device=dev)
        out.append(dh.host(dh.vcycle(dh.vector(np.zeros_like(b)),
                                     dh.vector(b))))
    err = float(np.abs(out[0] - out[1]).max() / np.abs(out[1]).max())
    print(f"reference: {n}^2 from_spmd, one float64 V-cycle, card against "
          f"CPU {err:.3e} of max |x|")
    if not err <= CARD_CPU_TOL:
        raise AssertionError(f"from_spmd V-cycle: card and CPU differ by "
                             f"{err}")
    return err


# phase 16: the setup over real OS processes and the device solve with one
# controller per shard (``comm.launch.run_controllers``: MC_CONTROLLERS
# interpreters on the one card, gloo, ``comm.bootstrap``), 15a's problem,
# setup and solve; then a small cycle on the card against the CPU
MC_CONTROLLERS = TAP_LAYOUT[0] * TAP_LAYOUT[1]
MC_CPU = (64, 2)      # 16b: side and controllers of the card-vs-CPU cycle
MC_TIMEOUT = 600


def mc_rows(n, world, rank):
    """One controller's rows of the n x n flagship problem: the rows of
    ``par_stencil_grid``'s shard ``rank`` of ``world``, built from the
    stencil and the rest dropped (the JAX package's tests/_mc_worker.py)."""
    from raptor_tpu_torch.comm.transport import split_rows
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    from raptor_tpu_torch.core.partition import Partition
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, stencil_grid)
    A = stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n))
    part = Partition.create(n * n, n * n, world)
    block = split_rows(A, part.row_bounds)[rank]
    del A
    return ParCSRMatrix.from_local_rows([block], part,
                                        first_shard=rank), block


def mc_setup(comm, n, group=None):
    """A controller's ``spmd_rs_setup`` of its rows (HMIS + extended+i,
    theta 0.25, the glibc weights) over ``group`` (its ``SocketGroup`` by
    default); returns (the hierarchy, the transport factory, its rows,
    seconds)."""
    from raptor_tpu_torch.comm.multiproc import MultiProcessTransport
    from raptor_tpu_torch.comm.spmd import spmd_rs_setup
    from raptor_tpu_torch.utils.glibc_rand import form_rand_weights
    group = comm.group if group is None else group
    t0 = time.perf_counter()
    a, block = mc_rows(n, comm.world, comm.rank)

    def make_transport(m):
        return MultiProcessTransport(group, m)

    hier = spmd_rs_setup(a, form_rand_weights(n * n, 0), make_transport)
    return hier, make_transport, block, time.perf_counter() - t0


def mc_controller(comm, n):
    """16a, one controller: its setup, ``from_spmd`` with ``comm``
    (float32 Chebyshev(3), lane pad 128), refinement to 1e-8 with
    b = A 1 (its launches counted from zero just before it and read just
    after), the host-recomputed residual, one V-cycle's device ms by CUDA
    events, enqueue ms and launches, then ``mc_profile``; returns them
    with its level blocks (A and P, global columns) for the parent to
    hold against 15a's."""
    import torch
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device import kernels
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    hier, make_transport, block, setup_s = mc_setup(comm, n)
    t0 = time.perf_counter()
    dh = DeviceHierarchy.from_spmd(
        hier, make_transport, relax_type=RelaxType.Chebyshev,
        num_smooth_sweeps=3, dtype=torch.float32, lane_pad=128,
        device=comm.device, comm=comm)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    out = mc_solve_report(torch, kernels, comm, dh, block, n)
    out.update(mc_profile(torch, kernels, dh, block.to_scipy() @ np.ones(
        n * n)))
    out.update({
        "setup_s": setup_s, "pack_s": pack_s,
        "a_blocks": [lvl.a_local.shards()[0].global_cols_csr(
            lvl.a_local.partition.global_num_cols) for lvl in hier.levels],
        "p_blocks": [lvl.p_block for lvl in hier.levels[:-1]]})
    return out


def mc_solve_report(torch, kernels, comm, dh, block, n):
    """A controller's refinement of ``dh`` to 1e-8 with b = A 1 (its
    launches counted from zero just before it and read just after), the
    host-recomputed residual, one V-cycle's device ms by CUDA events,
    enqueue ms and launches, the levels and formats."""
    g = comm.group
    b = block.to_scipy() @ np.ones(n * n)
    kernels.reset_launches()
    t0 = time.perf_counter()
    x, hist = dh.solve_mixed(np.zeros_like(b), b, tol=1e-8, max_iter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    x_all = np.concatenate(g.allgather(x))
    sums = np.sum(g.allgather(np.array(
        [np.sum((b - block.to_scipy() @ x_all) ** 2), np.sum(b ** 2)])),
        axis=0)
    xd = dh.vector(np.zeros_like(b))
    bd = dh.vector(b / np.sqrt(sums[1]))
    kernels.reset_launches()
    dh.vcycle(xd, bd)
    torch.cuda.synchronize()
    per_cycle = dict(kernels.LAUNCHES)
    t1 = time.perf_counter()
    dh.vcycle(xd, bd)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    # a cycle waits on about 80 host-staged collectives: 3 rounds suffice
    cycle_ms = time_ms(torch, lambda: dh.vcycle(xd, bd), reps=3, warm=1)
    return {
        "rank": comm.rank, "solve_s": solve_s, "refinements": len(hist) - 1,
        "res": float(hist[-1]), "relres": float(np.sqrt(sums[0] / sums[1])),
        "finite": bool(np.isfinite(x).all()), "launches": launches,
        "launches_per_vcycle": per_cycle, "vcycle_ms": cycle_ms,
        "vcycle_enqueue_ms": enqueue_ms,
        "levels": [lvl.A.global_num_rows for lvl in dh.levels],
        "formats": dh.format_summary()}


def mc_profile(torch, kernels, dh, b):
    """16a's profile, one controller, every controller at once:
    ``profile_cycle(PROFILE_REPS)`` (``print_times``' rows; its launches
    counted from zero just before it and read just after, and its
    seconds), and whether a V-cycle of ``b`` from zero after it equals one
    before it bit for bit."""
    def cycle():
        return dh.host(dh.vcycle(dh.vector(np.zeros_like(b)), dh.vector(b)))

    before = cycle()
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = dh.profile_cycle(reps=PROFILE_REPS)
    torch.cuda.synchronize()
    profile_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    return {"profile_rows": rows, "profile_s": profile_s,
            "profile_launches": launches,
            "vcycle_unchanged": before.tobytes() == cycle().tobytes()}


def print_profiles(stacked, ranks):
    """The stacked hierarchy's ``profile_cycle`` rows beside each
    controller's: one table a block (ms), one line a level."""
    for key, title in (("relax_s", "smoother"), ("spmv_s", "SpMV"),
                       ("transfer_s", "P (P^T x)")):
        print(f"  {title} ms: level, 15a stacked, controllers "
              + " ".join(str(r["rank"]) for r in ranks))
        for i, row in enumerate(stacked):
            print(f"  {row['level']:3d} {row[key] * 1e3:9.3f} "
                  + " ".join(f"{r['profile_rows'][i][key] * 1e3:8.3f}"
                             for r in ranks))


def mc_profile_check(ranks, stacked):
    """Every controller's rows: the stacked hierarchy's levels, every time
    finite and above 0 (the transfer 0 on the coarsest level only), and
    its V-cycle unchanged by profiling."""
    levels = [row["level"] for row in stacked]
    for r in ranks:
        rows = r["profile_rows"]
        ok = ([row["level"] for row in rows] == levels
              and r["vcycle_unchanged"]
              and rows[-1]["transfer_s"] == 0.0
              and all(np.isfinite(row[k]) and row[k] > 0
                      for row in rows for k in ("relax_s", "spmv_s"))
              and all(np.isfinite(row["transfer_s"])
                      and row["transfer_s"] > 0 for row in rows[:-1]))
        if not ok:
            raise AssertionError(f"controller {r['rank']} profile: "
                                 f"{rows}; V-cycle unchanged "
                                 f"{r['vcycle_unchanged']}")


def mc_cycle(comm, n, layout=None):
    """16b and 17c, one controller: one float64 V-cycle of its n x n
    from_spmd hierarchy on its device and on the CPU (lane pad 128 on
    both), b = A 1 from zero, with TAP on every level of
    ``make_mesh2(*layout)`` when a layout is given; returns its rows of
    both."""
    import torch
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    hier, make_transport, block, _ = mc_setup(comm, n)
    b = block.to_scipy() @ np.ones(n * n)
    tap = ({} if layout is None else
           {"mesh": make_mesh2(*layout), "tap_amg": 0})
    out = {}
    for dev in (comm.device, torch.device("cpu")):
        dh = DeviceHierarchy.from_spmd(
            hier, make_transport, relax_type=RelaxType.Chebyshev,
            num_smooth_sweeps=3, lane_pad=128, device=dev, comm=comm, **tap)
        out[dev.type] = dh.host(dh.vcycle(dh.vector(np.zeros_like(b)),
                                          dh.vector(b)))
    return out


def multi_controller(torch, hier15, bridge, kernels, by_path,
                     device="cuda"):
    """16: 15a's problem on MC_CONTROLLERS controllers of the one card,
    each holding its shard's rows only (``mc_controller``): 15a's levels
    and operators (within SPMD_TOL), its refinements, the host residual
    below 1e-8, DIA and BDIA launched by every controller; their launches
    summed into ``by_path["2d_mc"]``; every controller's ``profile_cycle``
    rows beside the stacked 15a hierarchy's (``bridge["plain"]``), their
    launches summed into ``by_path["2d_mc_profile"]``. Then ``mc_cycle``
    on MC_CPU's two controllers: card and CPU within CARD_CPU_TOL of max
    |x|."""
    from raptor_tpu_torch.comm.launch import run_controllers
    n = bridge["n"]
    world = MC_CONTROLLERS
    t0 = time.perf_counter()
    res = run_controllers(world, "chip_smoke:mc_controller", (n,),
                          device=device, timeout=MC_TIMEOUT)
    wall_s = time.perf_counter() - t0
    levels = res[0]["levels"]
    worst = max(
        spmd_levels_close(f"{world} controllers {n}^2",
                          [lvl.a_local.assemble_global()
                           for lvl in hier15.levels],
                          [stacked([r["a_blocks"][i] for r in res])
                           for i in range(len(levels))]),
        spmd_levels_close(f"{world} controllers {n}^2 P",
                          [stacked(lvl.p_blocks)
                           for lvl in hier15.levels[:-1]],
                          [stacked([r["p_blocks"][i] for r in res])
                           for i in range(len(levels) - 1)]))
    want = bridge["plain"]["refinements"]
    names = list(res[0]["launches"])
    by_path["2d_mc"] = {k: sum(r["launches"][k] for r in res)
                        for k in names}
    ranks = []
    for r in res:
        print(f"  controller {r['rank']}: setup {r['setup_s']:.3f} s, pack "
              f"{r['pack_s']:.3f} s, {r['refinements']} refinements to "
              f"{r['res']:.3e} (host {r['relres']:.3e}) in "
              f"{r['solve_s']:.3f} s; a cycle {r['vcycle_ms']:.3f} ms on the "
              f"card, enqueue {r['vcycle_enqueue_ms']:.3f} ms; launches in "
              f"the solve dia {r['launches']['dia_spmv']} bdia "
              f"{r['launches']['bdia_spmv']}, a cycle "
              f"{r['launches_per_vcycle']}", flush=True)
        if (r["refinements"] != want or r["res"] > 1e-8
                or r["relres"] > 1e-8 or not r["finite"]
                or r["levels"] != levels):
            raise AssertionError(f"controller {r['rank']}: "
                                 f"{r['refinements']} refinements to "
                                 f"{r['res']} (host {r['relres']}), 15a's "
                                 f"{want}")
        require_launches(f"controller {r['rank']}", r["launches"])
        ranks.append({k: v for k, v in r.items()
                      if k not in ("a_blocks", "p_blocks")})
    print("\n".join(res[0]["formats"]))
    print(f"{world} controllers {n}^2: levels {levels}, 15a's within "
          f"{worst:.3e}, {want} refinements as 15a; launches "
          f"{by_path['2d_mc']}; {wall_s:.3f} s", flush=True)
    stacked_rows = bridge["plain"]["profile_rows"]
    by_path["2d_mc_profile"] = {k: sum(r["profile_launches"][k]
                                       for r in res) for k in names}
    print(f"16a print_times (reps {PROFILE_REPS}) on every controller at "
          f"once, {min(r['profile_s'] for r in res):.3f}-"
          f"{max(r['profile_s'] for r in res):.3f} s; launches "
          f"{by_path['2d_mc_profile']}:")
    print_profiles(stacked_rows, res)
    mc_profile_check(res, stacked_rows)
    require_launches(f"{world} controllers' profiles",
                     by_path["2d_mc_profile"])
    cpu_n, cpu_world = MC_CPU
    t0 = time.perf_counter()
    cyc = run_controllers(cpu_world, "chip_smoke:mc_cycle", (cpu_n,),
                          device=device, timeout=MC_TIMEOUT)
    card = np.concatenate([c[torch.device(device).type] for c in cyc])
    cpu = np.concatenate([c["cpu"] for c in cyc])
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"reference: {cpu_n}^2 on {cpu_world} controllers, one float64 "
          f"V-cycle, card against CPU {err:.3e} of max |x| "
          f"({time.perf_counter() - t0:.3f} s)")
    if not err <= CARD_CPU_TOL:
        raise AssertionError(f"{cpu_world} controllers: card and CPU "
                             f"differ by {err}")
    return {"n": n, "controllers": world, "levels": levels,
            "setup_rel_diff": worst, "refinements": want,
            "launches": by_path["2d_mc"],
            "launches_per_vcycle": {
                k: sum(r["launches_per_vcycle"][k] for r in res)
                for k in names},
            "ranks": ranks, "run_s": wall_s, "card_cpu_rel_err": err,
            "stacked_profile_rows": stacked_rows}


# phase 17: TAP and the Krylov solvers across controllers, on
# MC_CONTROLLERS controllers laid out as TAP_LAYOUT (hosts x controllers a
# host): 17a the setup over ``TapGroup`` and the TAP solve of 15a's
# problem, 17b the Krylov solvers on the plain hierarchy, each in the
# iterations of the stacked route on 15a's per-rank setup, 17c a small
# TAP cycle on the card against the CPU. 17b's runs, each on the fine
# operator of a plain Chebyshev(3) hierarchy of its dtype with that
# hierarchy's V-cycle as the preconditioner, b = A 1 (the float32 ones
# are phase 10's): (name, module of raptor_tpu_torch.krylov, function,
# dtype, tolerance, other arguments). The float64 one keeps its solution,
# which must equal the stacked route's to MC_KRYLOV_X_TOL of max |x|: in
# float64 the routes' per-shard sums, which may reduce in other orders on
# a [1, R] stack than on an [8, R] one, round apart by about 1e-16
MC_KRYLOV = (("AMG-PCG", "cg", "cg", "float32", 1e-5, {}),
             ("Pre-BiCGStab", "bicgstab", "bicgstab", "float32", 1e-5, {}),
             ("AMG-GMRES(30)", "gmres", "gmres", "float32", 1e-5,
              {"restart": 30}),
             ("SeqInner Pre-BiCGStab (float64)", "bicgstab",
              "seq_inner_bicgstab", "float64", 1e-8, {}))
MC_KRYLOV_CAP = 200
MC_KRYLOV_X_TOL = 1e-12
MC_TAP_CPU = (64, (2, 2))   # 17c: side and layout of the card-vs-CPU cycle


def plain_hierarchies(torch, hier, make_transport, device, comm=None):
    """17b's plain Chebyshev(3) ``from_spmd`` hierarchies of ``hier``
    (lane pad 128), by dtype name: every shard on ``device``
    (``comm=None``) or this controller's."""
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    return {dt: DeviceHierarchy.from_spmd(
        hier, make_transport, relax_type=RelaxType.Chebyshev,
        num_smooth_sweeps=3, dtype=getattr(torch, dt), lane_pad=128,
        device=device, comm=comm) for dt in ("float32", "float64")}


def mc_krylov(torch, dhs, b):
    """17b's runs (MC_KRYLOV) from zero, each on the fine operator of the
    hierarchy of its dtype in ``dhs`` (``plain_hierarchies``) with that
    hierarchy's V-cycle as the preconditioner; ``b`` holds the
    hierarchies' rows (every row, or the controller's). Returns per run
    its iterations, relative residual, seconds and finiteness, and the
    float64 run's rows of x."""
    import importlib
    out = {}
    for name, mod, fn, dt, tol, kw in MC_KRYLOV:
        dh = dhs[dt]
        A = dh.levels[0].A
        x0, bd = dh.vector(np.zeros_like(b)), dh.vector(b)
        solve = getattr(importlib.import_module(
            f"raptor_tpu_torch.krylov.{mod}"), fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solve(A, x0, bd, tol=tol, max_iter=MC_KRYLOV_CAP,
                  precond=dh.precond_pack(), **kw)
        torch.cuda.synchronize()
        # CG and GMRES hold ||r|| / ||b||, BiCGStab ||r||; x0 = 0
        out[name] = {"iters": r.n_iters,
                     "rel_res": float(r.res[r.n_iters] / r.res[0]),
                     "s": time.perf_counter() - t0,
                     "finite": bool(torch.isfinite(r.x).all())}
        if dt == "float64":
            out[name]["x"] = dh.host(r.x)
    return out


def mc_tap_controller(comm, n):
    """17a and 17b, one controller: ``mc_setup`` over ``TapGroup(
    comm.group, ppn)`` (ppn the controllers a host of TAP_LAYOUT), then
    ``from_spmd`` with TAP on every level of ``make_mesh2(*TAP_LAYOUT)``
    and ``comm`` (float32 Chebyshev(3), lane pad 128) refined to 1e-8
    with b = A 1, as ``mc_controller``; then the plain hierarchies
    (``tap_amg=-1``) and ``mc_krylov`` on them. Returns its level blocks,
    the group's send counts, and what ``mc_controller`` returns of a
    solve."""
    import torch
    from raptor_tpu_torch.comm.tapgroup import TapGroup
    from raptor_tpu_torch.core.types import RelaxType
    from raptor_tpu_torch.device import kernels
    from raptor_tpu_torch.device.par import make_mesh2
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    group = TapGroup(comm.group, TAP_LAYOUT[1])
    hier, make_transport, block, setup_s = mc_setup(comm, n, group)
    kw = dict(relax_type=RelaxType.Chebyshev, num_smooth_sweeps=3,
              dtype=torch.float32, lane_pad=128, device=comm.device,
              comm=comm)
    t0 = time.perf_counter()
    dh = DeviceHierarchy.from_spmd(hier, make_transport,
                                   mesh=make_mesh2(*TAP_LAYOUT), tap_amg=0,
                                   **kw)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    out = mc_solve_report(torch, kernels, comm, dh, block, n)
    out.update({
        "setup_s": setup_s, "pack_s": pack_s,
        "inter_sends": group.inter_sends, "intra_sends": group.intra_sends,
        "tap_levels": sum(lvl.TA is not None for lvl in dh.levels),
        "a_blocks": [lvl.a_local.shards()[0].global_cols_csr(
            lvl.a_local.partition.global_num_cols) for lvl in hier.levels],
        "p_blocks": [lvl.p_block for lvl in hier.levels[:-1]]})
    del dh
    t0 = time.perf_counter()
    dhs = plain_hierarchies(torch, hier, make_transport, comm.device, comm)
    torch.cuda.synchronize()
    out["plain_pack_s"] = time.perf_counter() - t0
    b = block.to_scipy() @ np.ones(n * n)
    kernels.reset_launches()
    out["krylov"] = mc_krylov(torch, dhs, b)
    out["krylov_launches"] = dict(kernels.LAUNCHES)
    return out


def mc_tap_krylov(torch, hier15, bridge, mc16, kernels, by_path,
                  device="cuda"):
    """17 (see the module docstring): first 17b's runs on the stacked
    route (15a's per-rank setup, ``hier15``, packed plain by
    ``from_spmd`` on the card: ``plain_hierarchies``), then
    ``mc_tap_controller`` on MC_CONTROLLERS controllers: 15a's levels,
    operators and P (within SPMD_TOL), 15a's TAP refinements
    (``bridge``) and its launches a cycle, the host residual below 1e-8,
    TapGroup's send counts summed; each controller's cycle beside 16a's
    (``mc16``); 17b's iterations those of the stacked route and the
    float64 run's rows within MC_KRYLOV_X_TOL of max |x|. Then
    ``mc_cycle`` with TAP on MC_TAP_CPU's layout: card and CPU within
    CARD_CPU_TOL of max |x|. Launches go to ``by_path["2d_mc_tap"]`` (the
    TAP solves) and ``"2d_mc_krylov"``."""
    from raptor_tpu_torch.comm.launch import run_controllers
    from raptor_tpu_torch.comm.transport import InProcessTransport
    n = bridge["n"]
    world = MC_CONTROLLERS
    t0 = time.perf_counter()
    dhs = plain_hierarchies(torch, hier15, InProcessTransport, device)
    a = hier15.levels[0].a_local
    ref_krylov = mc_krylov(torch, dhs, a.mult(np.ones(a.global_num_rows)))
    del dhs
    torch.cuda.empty_cache()
    stacked_s = time.perf_counter() - t0
    for name, c in ref_krylov.items():
        print(f"  stacked {name:32s}: {c['iters']:4d} iterations to "
              f"{c['rel_res']:.3e} in {c['s']:.3f} s", flush=True)
    t0 = time.perf_counter()
    res = run_controllers(world, "chip_smoke:mc_tap_controller", (n,),
                          device=device, timeout=MC_TIMEOUT)
    wall_s = time.perf_counter() - t0
    levels = res[0]["levels"]
    worst = max(
        spmd_levels_close(f"{world} controllers over TapGroup {n}^2",
                          [lvl.a_local.assemble_global()
                           for lvl in hier15.levels],
                          [stacked([r["a_blocks"][i] for r in res])
                           for i in range(len(levels))]),
        spmd_levels_close(f"{world} controllers over TapGroup {n}^2 P",
                          [stacked(lvl.p_blocks)
                           for lvl in hier15.levels[:-1]],
                          [stacked([r["p_blocks"][i] for r in res])
                           for i in range(len(levels) - 1)]))
    want = bridge["tap0"]["refinements"]
    want_cycle = bridge["tap0"]["launches_per_vcycle"]
    tols = {name: tol for name, _, _, _, tol, _ in MC_KRYLOV}
    names = list(res[0]["launches"])
    by_path["2d_mc_tap"] = {k: sum(r["launches"][k] for r in res)
                            for k in names}
    by_path["2d_mc_krylov"] = {k: sum(r["krylov_launches"][k] for r in res)
                               for k in names}
    ranks = []
    for r, r16 in zip(res, mc16["ranks"]):
        print(f"  controller {r['rank']}: setup over TapGroup "
              f"{r['setup_s']:.3f} s (inter-node sends {r['inter_sends']}, "
              f"intra-node {r['intra_sends']}), TAP pack {r['pack_s']:.3f} "
              f"s, {r['refinements']} refinements to {r['res']:.3e} (host "
              f"{r['relres']:.3e}) in {r['solve_s']:.3f} s; a TAP cycle "
              f"{r['vcycle_ms']:.3f} ms on the card, enqueue "
              f"{r['vcycle_enqueue_ms']:.3f} ms (16a's plain cycle "
              f"{r16['vcycle_ms']:.3f} / {r16['vcycle_enqueue_ms']:.3f} ms); "
              f"launches a cycle {r['launches_per_vcycle']}", flush=True)
        if (r["refinements"] != want or r["res"] > 1e-8
                or r["relres"] > 1e-8 or not r["finite"]
                or r["levels"] != levels
                or r["tap_levels"] != len(levels)):
            raise AssertionError(f"controller {r['rank']}: "
                                 f"{r['refinements']} TAP refinements to "
                                 f"{r['res']} (host {r['relres']}), 15a's "
                                 f"{want}")
        require_launches(f"controller {r['rank']} TAP", r["launches"])
        if any(r["launches_per_vcycle"][k] != want_cycle[k]
               for k in ("dia_spmv", "bdia_spmv")):
            raise AssertionError(f"controller {r['rank']}: a TAP cycle "
                                 f"launches {r['launches_per_vcycle']}, "
                                 f"15a's {want_cycle}")
        for name, c in r["krylov"].items():
            ref = ref_krylov[name]
            tol = tols[name]
            print(f"    {name:32s}: {c['iters']:4d} iterations to "
                  f"{c['rel_res']:.3e} in {c['s']:.3f} s", flush=True)
            if (c["iters"] != ref["iters"] or not c["rel_res"] <= tol
                    or not c["finite"]):
                raise AssertionError(f"controller {r['rank']} {name}: "
                                     f"{c['iters']} iterations to "
                                     f"{c['rel_res']}, the stacked route's "
                                     f"{ref['iters']}")
        require_launches(f"controller {r['rank']} Krylov",
                         r["krylov_launches"])
        ranks.append({k: v for k, v in r.items()
                      if k not in ("a_blocks", "p_blocks", "krylov")})
        ranks[-1]["krylov"] = {k: {f: v for f, v in c.items() if f != "x"}
                               for k, c in r["krylov"].items()}
    seq = next(m for m, _, _, dt, _, _ in MC_KRYLOV if dt == "float64")
    x_ref = ref_krylov[seq]["x"]
    x_mc = np.concatenate([r["krylov"][seq]["x"] for r in res])
    x_err = float(np.abs(x_mc - x_ref).max() / np.abs(x_ref).max())
    inter = sum(r["inter_sends"] for r in res)
    intra = sum(r["intra_sends"] for r in res)
    print("\n".join(res[0]["formats"]))
    print(f"{world} controllers {n}^2, TAP on every level: levels "
          f"{levels}, 15a's within {worst:.3e}, {want} refinements as 15a; "
          f"TapGroup sends {inter} inter-node, {intra} intra-node; "
          f"launches {by_path['2d_mc_tap']}; Krylov the stacked route's "
          f"iterations, {seq} x {x_err:.3e} of max |x| from it; launches "
          f"{by_path['2d_mc_krylov']}; {wall_s:.3f} s", flush=True)
    if not x_err <= MC_KRYLOV_X_TOL:
        raise AssertionError(f"{seq}: controllers and the stacked route "
                             f"differ by {x_err} of max |x|")
    cpu_n, layout = MC_TAP_CPU
    t1 = time.perf_counter()
    cyc = run_controllers(layout[0] * layout[1], "chip_smoke:mc_cycle",
                          (cpu_n, layout), device=device,
                          timeout=MC_TIMEOUT)
    card = np.concatenate([c[torch.device(device).type] for c in cyc])
    cpu = np.concatenate([c["cpu"] for c in cyc])
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"reference: {cpu_n}^2 on {layout[0]} x {layout[1]} controllers, "
          f"one float64 TAP V-cycle, card against CPU {err:.3e} of max |x| "
          f"({time.perf_counter() - t1:.3f} s)")
    if not err <= CARD_CPU_TOL:
        raise AssertionError(f"TAP across controllers: card and CPU differ "
                             f"by {err}")
    return {"n": n, "controllers": world, "layout": list(TAP_LAYOUT),
            "levels": levels, "setup_rel_diff": worst, "refinements": want,
            "inter_sends": inter, "intra_sends": intra,
            "launches": by_path["2d_mc_tap"],
            "launches_per_vcycle": {
                k: sum(r["launches_per_vcycle"][k] for r in res)
                for k in names},
            "krylov_launches": by_path["2d_mc_krylov"],
            "stacked_krylov": {k: {f: v for f, v in c.items() if f != "x"}
                               for k, c in ref_krylov.items()},
            "stacked_s": stacked_s, "seq_x_rel_err": x_err,
            "ranks": ranks, "run_s": wall_s, "card_cpu_rel_err": err}


# phase 18: systems AMG and RAP sparsification in the Ruge-Stuben setup,
# and the profiling layer. 18a and 18b run on three controllers of the
# card (18a, 18b sparsified, 18b unsparsified), which set up and pack at
# the same time, so that their setup and pack seconds are those of three
# processes sharing the host and the card; then, once all are ready, each
# does its timed work (18a's replay, the solve, the cycle) in its turn
# while the others wait at a barrier, so that nothing else runs on the
# host or the card while it is timed. 18a's unknown-based solve
# (float32, b = A 1) must reach 1e-8 within SYS_REFINEMENTS + 1
# refinements; level 0's modified-classical
# interpolation replayed through the device engine with the variables must
# equal the host P's pattern and its values to SYS_REPLAY_TOL of max
# |host|, and a SYS_CPU^2 float64 systems V-cycle on the card the CPU's to
# SYS_REPLAY_TOL of max |x| (the whole solve's x to CARD_CPU_TOL; the gap
# is printed after each of SYS_GAP_CYCLES cycles and the solve's last).
# 18b: tests/test_multilevel.py::test_sparsify_large_2d's configuration at
# (n/2)^2, its 1024^2 by default; the coarse operators' nnz over the fine
# one's below SPARSIFY_NNZ_RATIO (the JAX test's bound), each sparsified
# operator symmetric to SPARSIFY_SYM_TOL and its row sums the Galerkin
# product's to SPARSIFY_ROWSUM_TOL, both relative to the product's largest
# entry; each solve within SPARSIFY_REFINEMENTS + 1 refinements. The
# counts are the JAX package's on the same configurations (a float32
# hierarchy refined in float64 to 1e-8, b = A 1, lane padding 1), the most
# the port may take plus one, as 14a holds TAP_CYCLES; at other sizes the
# solves are held to 1e-8 within solve_mixed's 100. 18a, from a CPU run of
# the JAX package:
#   JAX_PLATFORMS=cpu python -c "import numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.core.types import CoarsenType as C, InterpType as I, \
#   RelaxType as R; from raptor_tpu.device.par import make_mesh; from \
#   raptor_tpu.gallery.fem import par_fem; from \
#   raptor_tpu.multilevel.device_hierarchy import DeviceHierarchy as DH; \
#   from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver \
#   as RS; A, v = par_fem('elasticity', 1024, 512, 1); ml = RS(0.25, \
#   C.CLJP, I.ModClassical, relax_type=R.Chebyshev); ml.num_smooth_sweeps \
#   = 3; ml.num_variables = 2; ml.variables = v; ml.rap_mode = \
#   ml.interp_mode = 'host'; ml.setup(A); b = \
#   A.mult(np.ones(A.global_num_rows)); _, h = DH(ml, make_mesh(1), \
#   dtype=jnp.float32, lane_pad=1).solve_mixed(0 * b, b, tol=1e-8, \
#   max_iter=200); print([l.A.global_num_rows for l in ml.levels], \
#   len(h) - 1, h[-1])"
# 18b, sparsified (TOL 0.4) and not (TOL 0.0):
#   JAX_PLATFORMS=cpu python -c "import sys, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.core.types import CoarsenType as C, InterpType as I, \
#   RelaxType as R; from raptor_tpu.device.par import make_mesh; from \
#   raptor_tpu.gallery.stencils import diffusion_stencil_2d as D, \
#   par_stencil_grid as G; from raptor_tpu.multilevel.device_hierarchy \
#   import DeviceHierarchy as DH; from \
#   raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver as RS; \
#   n, tol = 1024, float(sys.argv[1]); A = G(D(0.001, np.pi / 8), (n, n), \
#   1); ml = RS(0.25, C.CLJP, I.ModClassical, relax_type=R.Chebyshev); \
#   ml.num_smooth_sweeps = 3; ml.sparsify_tol = tol; ml.rap_mode = \
#   ml.interp_mode = 'host'; ml.setup(A); b = A.mult(np.ones(n * n)); _, h \
#   = DH(ml, make_mesh(1), dtype=jnp.float32, lane_pad=1).solve_mixed(0 * \
#   b, b, tol=1e-8, max_iter=200); print([l.A.nnz for l in ml.levels], \
#   len(h) - 1, h[-1])" TOL
P18_TIMEOUT = 600
SYS_REFINEMENTS = {(1024, 512): 37}
SPARSIFY_REFINEMENTS = {(1024, 0.4): 62, (1024, 0.0): 41}
SYS_REPLAY_TOL = 1e-14
SYS_CPU = 24
SYS_GAP_CYCLES = (1, 6, 12)
SPARSIFY_TOL = 0.4
SPARSIFY_NNZ_RATIO = 2.5
SPARSIFY_SYM_TOL = 1e-10
SPARSIFY_ROWSUM_TOL = 1e-12
PROFILE_REPS = 20
PROFILE_PAIRS = 5


def jax_count_limit(counts, key):
    """The most refinements a phase 18 solve may take: the JAX package's
    count at ``key`` plus one, None (1e-8 within solve_mixed's 100) where
    it has none."""
    k = counts.get(key)
    return None if k is None else k + 1


def systems_setup(nx, ny):
    """18a's setup: the scalar Q1 elasticity matrix of phase 12, CLJP +
    modified classical, theta 0.25, Chebyshev(3), two unknowns a node
    (the gallery's variable ids), host engines; with the
    ``par_interpolation`` calls recorded (``interp_inputs``)."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery.fem import par_fem
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    A, variables = par_fem("elasticity", nx, ny, 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.num_variables = 2
    ml.variables = variables
    ml.rap_mode = ml.interp_mode = "host"
    record = []
    with interp_inputs(record):
        ml.setup(A)
    return A, ml, record


def systems_replay(torch, ml, record):
    """18a: level 0's modified-classical interpolation with its variables
    through the device engine on the card, against the host engine's P."""
    from raptor_tpu_torch.ruge_stuben import interpolation as itp
    a, s, states, kind, ph, host_s = record[0]
    t0 = time.perf_counter()
    pd = itp.par_interpolation(a, s, states, kind, "device", "cuda",
                               ml.num_variables, ml.levels[0].variables)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    if itp.LAST_ENGINE["interp"] != "device":
        raise AssertionError(f"systems replay: the device engine did not "
                             f"run ({itp.LAST_ENGINE})")
    err = replay_error("systems level 0 interpolation", pd.global_csr,
                       ph.global_csr, SYS_REPLAY_TOL)
    print(f"  level 0 modified classical with variables: device engine "
          f"{dev_s:.3f} s, host {host_s:.3f} s, {err:.3e} of max |host| "
          f"(nnz {ph.nnz})", flush=True)
    return {"interp_device_s": dev_s, "interp_host_s": host_s,
            "interp_err": err, "p_nnz": ph.nnz}


def systems_reference_check(torch, n=SYS_CPU):
    """18a: an n x n float64 systems hierarchy on the card and with the
    plain versions on the CPU: one V-cycle from zero within
    SYS_REPLAY_TOL of max |x|, and the solve to 1e-9 in the same cycles,
    its residual histories within 1e-9 and x within CARD_CPU_TOL of
    max |x| (each cycle's rounding, amplified by the operator's
    conditioning, moves the solution of a whole solve further than one
    cycle's: the gap after SYS_GAP_CYCLES cycles and the solve's last is
    printed to show it). Returns (cycle error, solve error, the gaps by
    cycle)."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    A, ml, _ = systems_setup(n, n)
    b = A.mult(np.ones(A.global_num_rows))
    out = {}
    for dev in ("cuda", "cpu"):
        dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=128,
                             device=dev)
        dh.solve_tol = 1e-9
        bd = dh.vector(b)
        r = dh.solve(torch.zeros_like(bd), bd)
        x, xs = torch.zeros_like(bd), {}
        for k in range(1, max(SYS_GAP_CYCLES) + 1):
            x = dh.vcycle(x, bd)
            if k in SYS_GAP_CYCLES:
                xs[k] = dh.host(x)
        out[dev] = (xs, r, dh.host(r.x))
    (xg, rg, sg), (xc, rc, sc) = out["cuda"], out["cpu"]

    def gap(u, v):
        return float(np.abs(u - v).max() / np.abs(v).max())
    k = rc.n_iters
    gaps = {c: gap(xg[c], xc[c]) for c in SYS_GAP_CYCLES}
    gaps[k] = err = gap(sg, sc)
    cyc_err = gaps[1]
    print(f"reference: {n} x {n} float64 systems hierarchy, card against "
          f"CPU: one V-cycle {cyc_err:.3e} of max |x|, the solve ({k} "
          f"cycles to {rc.res[k]:.3e}) {err:.3e}; x apart after "
          + ", ".join(f"{c} cycles {g:.3e}" for c, g in gaps.items()))
    if (rg.n_iters != k or not cyc_err <= SYS_REPLAY_TOL
            or not err <= CARD_CPU_TOL
            or not np.allclose(rg.res[:k + 1], rc.res[:k + 1], rtol=1e-9,
                               atol=1e-16)):
        raise AssertionError(f"systems {n} x {n}: card {rg.n_iters} cycles,"
                             f" CPU {k}; a cycle {cyc_err:.3e}, x "
                             f"{err:.3e} apart")
    return cyc_err, err, gaps


def pack_float32(torch, ml):
    """The float32 device hierarchy of a setup, with its seconds and
    formats."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float32)
    torch.cuda.synchronize()
    return dh, {"pack_s": time.perf_counter() - t0,
                "formats": dh.format_summary()}


def systems_prepare(torch, nx, ny):
    """18a's setup and pack (see the module docstring); returns the timed
    work to run in this controller's turn (the replay, the solve, the
    cycle)."""
    t0 = time.perf_counter()
    A, ml, record = systems_setup(nx, ny)
    setup_s = time.perf_counter() - t0
    del record[1:]
    print(ml.print_hierarchy())
    print(ml.print_setup_times())
    out = {"nx": nx, "ny": ny,
           "levels": [lvl.A.global_num_rows for lvl in ml.levels],
           "nnz": [lvl.A.nnz for lvl in ml.levels], "setup_s": setup_s,
           "setup_phase_totals": dict(ml.setup_times.times)}
    print(f"systems setup at {nx} x {ny} (num_variables 2): {ml.num_levels} "
          f"levels in {setup_s:.3f} s; coarsest variables "
          f"{np.bincount(ml.levels[-1].variables).tolist()}")
    dh, packed = pack_float32(torch, ml)
    out.update(packed)
    print(f"systems device hierarchy (float32): {out['pack_s']:.3f} s")
    print("\n".join(out["formats"]))

    def measure(kernels):
        out["replay"] = systems_replay(torch, ml, record)
        del record[:]
        b = A.mult(np.ones(A.global_num_rows))
        out["refinements"], out["launches"], out["solve_s_first"] = \
            drive_solve(torch, dh, A, b, f"systems {nx} x {ny}, b = A 1",
                        kernels, limit=jax_count_limit(SYS_REFINEMENTS,
                                                       (nx, ny)))
        out.update(cycle_report(torch, dh, b, kernels))
        return out
    return measure


@contextlib.contextmanager
def galerkin_products(record):
    """Record the Galerkin product each ``sparsify`` call of a setup
    sparsifies (its ``ac`` argument), level by level."""
    from raptor_tpu_torch.multilevel import par_multilevel as pm
    real = pm.sparsify

    def spy(a, p, i_mat, ap, ac, *args):
        record.append(ac.global_csr)
        return real(a, p, i_mat, ap, ac, *args)

    pm.sparsify = spy
    try:
        yield
    finally:
        pm.sparsify = real


def sparsify_setup(n, tol, record):
    """18b's setup: n x n rotated anisotropic diffusion, CLJP + modified
    classical, theta 0.25, Chebyshev(3), ``sparsify_tol = tol`` with the
    symmetric rule, host engines, one shard; each Galerkin product it
    sparsifies goes into ``record``."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.sparsify_tol = tol
    ml.rap_mode = ml.interp_mode = "host"
    with galerkin_products(record):
        ml.setup(A)
    return A, ml


def sparsify_checks(ml, products):
    """Each sparsified coarse operator against the Galerkin product it was
    sparsified from: symmetric, and with that product's row sums, both
    relative to the product's largest entry. Returns the worst of each."""
    sym = rows = 0.0
    for g, coarse in zip(products, ml.levels[1:]):
        g, c = g.to_scipy(), coarse.A.global_csr.to_scipy()
        scale = abs(g).max()
        sym = max(sym, abs(c - c.T).max() / scale)
        rows = max(rows, float(np.abs(np.asarray(c.sum(axis=1))
                                      - np.asarray(g.sum(axis=1))).max())
                   / scale)
    if sym > SPARSIFY_SYM_TOL or rows > SPARSIFY_ROWSUM_TOL:
        raise AssertionError(f"sparsified operators: symmetric to {sym:.3e},"
                             f" row sums to {rows:.3e}")
    return sym, rows


def sparsify_prepare(torch, n, tol):
    """18b's setup and pack for one ``sparsify_tol`` (see the module
    docstring); returns the measurement to run in this controller's
    turn."""
    key = "sparsified" if tol > 0 else "plain"
    products = []
    t0 = time.perf_counter()
    A, ml = sparsify_setup(n, tol, products)
    setup_s = time.perf_counter() - t0
    nnz = [lvl.A.nnz for lvl in ml.levels]
    ratio = sum(nnz[1:]) / nnz[0]
    print(f"18b {key} setup at {n}^2: {ml.num_levels} levels in "
          f"{setup_s:.3f} s, nnz {nnz}, coarse / fine nnz {ratio:.4f}; "
          f"phases " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(
              ml.setup_times.times.items())), flush=True)
    out = {"n": n, "sparsify_tol": tol,
           "levels": [lvl.A.global_num_rows for lvl in ml.levels],
           "nnz": nnz, "coarse_fine_nnz": ratio, "setup_s": setup_s,
           "setup_phase_totals": dict(ml.setup_times.times)}
    if tol > 0:
        if not ratio < SPARSIFY_NNZ_RATIO:
            raise AssertionError(f"sparsified {n}^2: coarse / fine nnz "
                                 f"{ratio}")
        out["sym_rel_err"], out["rowsum_rel_err"] = sparsify_checks(
            ml, products)
        print(f"  sparsified operators symmetric to "
              f"{out['sym_rel_err']:.3e}, row sums to "
              f"{out['rowsum_rel_err']:.3e} of the Galerkin product's "
              f"largest entry")
    del products
    dh, packed = pack_float32(torch, ml)
    out.update(packed)

    def measure(kernels):
        b = A.mult(np.ones(A.global_num_rows))
        out["refinements"], out["launches"], out["solve_s_first"] = \
            drive_solve(torch, dh, A, b, f"{n}^2 {key}, b = A 1", kernels,
                        limit=jax_count_limit(SPARSIFY_REFINEMENTS, (n, tol)))
        out.update(cycle_report(torch, dh, b, kernels))
        return out
    return measure


def p18_worker(comm, jobs):
    """Phase 18a / 18b on one controller: job ``jobs[comm.rank]``, either
    ("systems", nx, ny) or ("sparsify", n, tol). Its setup and pack run
    while the others run theirs; once every controller is ready, each
    runs its timed work in its turn, rank by rank, while the others wait
    at a barrier. Returns its summary with what it printed (``log``)."""
    import io

    import torch
    import torch.distributed as dist

    from raptor_tpu_torch.device import kernels
    job, *args = jobs[comm.rank]
    prepare = {"systems": systems_prepare, "sparsify": sparsify_prepare}[job]
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        measure = prepare(torch, *args)
        prep_s = time.perf_counter() - t0
        # the profiler's first start in a process is slow: made here, so
        # that a turn holds only its timed work
        t0 = time.perf_counter()
        device_kernels(torch, lambda: torch.ones(1, device="cuda").sum())
        print(f"profiler started in {time.perf_counter() - t0:.3f} s")
        for turn in range(comm.world):
            dist.barrier()
            if turn == comm.rank:
                t0 = time.perf_counter()
                out = measure(kernels)
                turn_s = time.perf_counter() - t0
        dist.barrier()
    return {**out, "prep_s": prep_s, "turn_s": turn_s,
            "log": log.getvalue()}


def systems_and_sparsify(torch, bsr_size, n, bsr, by_path):
    """18a and 18b: the card-against-CPU check of 18a here, then the
    three setups on three controllers (``p18_worker``); each one's
    output is printed here, and the solves' launches go to ``by_path``
    (``systems_solve``, ``sparsify_sparsified``, ``sparsify_plain``).
    ``bsr`` is phase 12's summary at ``bsr_size``, printed beside 18a."""
    from raptor_tpu_torch.comm.launch import run_controllers
    cyc_err, err, gaps = systems_reference_check(torch)
    jobs = (("systems", *bsr_size), ("sparsify", n, SPARSIFY_TOL),
            ("sparsify", n, 0.0))
    t0 = time.perf_counter()
    res = run_controllers(len(jobs), "chip_smoke:p18_worker", (jobs,),
                          timeout=P18_TIMEOUT)
    wall_s = time.perf_counter() - t0
    for r in res:
        print(r.pop("log"), end="")
    print("18a / 18b controllers: setup and pack s " + " / ".join(
        f"{r['prep_s']:.3f}" for r in res) + "; timed turn s " + " / ".join(
        f"{r['turn_s']:.3f}" for r in res))
    systems, sparsified, plain = res
    systems.update(card_cpu_cycle_rel_err=cyc_err, card_cpu_rel_err=err,
                   card_cpu_gap_by_cycle=gaps)
    for key, r in (("systems_solve", systems),
                   ("sparsify_sparsified", sparsified),
                   ("sparsify_plain", plain)):
        by_path[key] = r.pop("launches")
    systems["bsr"] = {f: bsr[f] for f in (
        "levels", "setup_s", "pack_s", "cycles", "vcycle_ms",
        "vcycle_enqueue_ms", "vcycle_busy_ms", "launches_per_vcycle")}
    print(f"18a beside phase 12's blocked AMG on the same matrix: levels "
          f"{len(systems['levels'])} / {len(bsr['levels'])}, setup "
          f"{systems['setup_s']:.3f} / {bsr['setup_s']:.3f} s, pack "
          f"{systems['pack_s']:.3f} / {bsr['pack_s']:.3f} s, a cycle "
          f"{systems['vcycle_ms']:.3f} ms float32 / {bsr['vcycle_ms']:.3f} "
          f"ms float64 (busy {systems['vcycle_busy_ms']:.3f} / "
          f"{bsr['vcycle_busy_ms']:.3f} ms), {systems['refinements']} "
          f"refinements to 1e-8 / {bsr['cycles']} blocked V-cycles to 1e-6")
    print(f"18b: refinements {sparsified['refinements']} sparsified / "
          f"{plain['refinements']} unsparsified; coarse / fine nnz "
          f"{sparsified['coarse_fine_nnz']:.4f} / "
          f"{plain['coarse_fine_nnz']:.4f}; a cycle "
          f"{sparsified['vcycle_ms']:.3f} / {plain['vcycle_ms']:.3f} ms, busy "
          f"{sparsified['vcycle_busy_ms']:.3f} / "
          f"{plain['vcycle_busy_ms']:.3f} ms ({len(jobs)} controllers, "
          f"{wall_s:.3f} s)", flush=True)
    return {"systems": systems,
            "sparsify": {"sparsified": sparsified, "plain": plain},
            "controllers_s": wall_s}


def profile_levels(torch, dh, what, cyc):
    """18c on a hierarchy of the run: ``print_times``' table, its rows by
    ``profile_cycle(PROFILE_REPS)``, beside PROFILE_REPS V-cycles timed
    the same way (``interleaved_seconds``) right after, PROFILE_PAIRS
    such pairs in a row: the host's pace, which sets an enqueue-bound
    cycle's, moves by a quarter within a second, so each table is held
    to the cycle of its own pair. Prints the median of each entry over
    the pairs and the median of the pairs' ratios of the cycle the rows
    add up to (two smoothings, a residual and a transfer round trip a
    level; the coarse solve and the vector updates left out) to the
    timed cycle, beside the cycle ``cyc`` measured earlier; fails unless
    every level's smoother and SpMV seconds are finite and above 0."""
    from raptor_tpu_torch.multilevel.device_hierarchy import format_times
    from raptor_tpu_torch.profiling.timers import interleaved_seconds
    b = dh.levels[0].A.row_mask.to(dh.dtype)
    t0 = time.perf_counter()
    tables, summed, chain = [], [], []
    for _ in range(PROFILE_PAIRS):
        rows = dh.profile_cycle(reps=PROFILE_REPS)
        tables.append(rows)
        summed.append(1e3 * sum(2 * r["relax_s"] + r["spmv_s"]
                                + r["transfer_s"] for r in rows[:-1]))
        chain.append(1e3 * interleaved_seconds(
            {"cycle": (lambda x: dh.vcycle(x, b), torch.zeros_like(b),
                       None)}, PROFILE_REPS)["cycle"])
    s = time.perf_counter() - t0
    rows = [{k: (r[k] if k == "level" else
                 statistics.median(t[i][k] for t in tables)) for k in r}
            for i, r in enumerate(tables[0])]
    bad = [r["level"] for t in tables for r in t
           if not all(np.isfinite(r[k]) and r[k] > 0
                      for k in ("relax_s", "spmv_s"))]
    if bad:
        raise AssertionError(f"{what} print_times: levels {bad} not > 0: "
                             f"{tables}")
    ratios = [u / v for u, v in zip(summed, chain)]
    ratio = statistics.median(ratios)
    print(f"18c print_times ({what}, reps {PROFILE_REPS}, the median of "
          f"{PROFILE_PAIRS} tables, {s:.3f} s):\n{format_times(rows)}\n"
          f"  levels summed / a cycle timed the same way right after, ms: "
          + ", ".join(f"{u:.3f} / {v:.3f}" for u, v in zip(summed, chain))
          + f"; the median ratio {ratio:.3f}; the cycle measured before "
          f"{cyc['vcycle_ms']:.3f} ms, its levels {sum(cyc['level_ms']):.3f}"
          f" ms", flush=True)
    return {"rows": rows, "summed_ms": summed, "chain_cycle_ms": chain,
            "summed_over_cycle": ratios, "median_ratio": ratio,
            "vcycle_ms": cyc["vcycle_ms"], "level_ms": cyc["level_ms"],
            "seconds": s}


def trace_kernel_names(path):
    """The kernel names of a Chrome trace (``device_trace``'s file)."""
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]


def profile_krylov(torch, dh, b, iters, ms_per_iter):
    """18c on phase 10's float32 Chebyshev(3) hierarchy: ``pcg_time_split``
    of its AMG-PCG beside the measured iterations, and ``device_trace``
    around one V-cycle, written under the git-ignored build/, whose
    kernels must include DIA and BDIA."""
    import pathlib
    from raptor_tpu_torch.krylov.profile import pcg_time_split
    from raptor_tpu_torch.profiling.timers import device_trace
    A = dh.levels[0].A
    split = pcg_time_split(A, b, dh.precond_pack())
    print("18c pcg_time_split (AMG-PCG, ms an iteration): " + ", ".join(
        f"{k} {v * 1e3:.3f}" for k, v in split.items())
        + f"; measured {ms_per_iter:.3f} ms an iteration over {iters}")
    if not all(np.isfinite(v) and v > 0 for v in split.values()):
        raise AssertionError(f"pcg_time_split: {split}")
    logdir = pathlib.Path(__file__).resolve().parent / "build" / \
        "trace18"
    xd = torch.zeros_like(b)
    dh.vcycle(xd, b)
    t0 = time.perf_counter()
    with device_trace(str(logdir)) as path:
        dh.vcycle(xd, b)
    names = trace_kernel_names(path)
    n_bdia = sum("bdia_spmv" in n for n in names)
    n_dia = sum("dia_spmv" in n and "bdia_spmv" not in n for n in names)
    print(f"18c device_trace: one V-cycle, {len(names)} kernels, DIA "
          f"{n_dia}, BDIA {n_bdia}, {os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.3f} s ({path})", flush=True)
    if not (n_dia and n_bdia):
        raise AssertionError(f"device_trace names no DIA / BDIA kernel: "
                             f"{sorted(set(names))[:20]}")
    return {"pcg_time_split": split, "pcg_ms_per_iter": ms_per_iter,
            "trace": {"kernels": len(names), "dia": n_dia, "bdia": n_bdia,
                      "bytes": os.path.getsize(path)}}


def comm_model(ml, word_bytes):
    """18c: ``model_comm_plan`` and ``model_tap_plan`` on every level of
    14b's 8-shard setup laid out as TAP_LAYOUT: TAP's bytes across hosts
    at most the plain plan's and exactly its G step's (the deduplicated
    values that cross, ``dcn_values``)."""
    from raptor_tpu_torch.comm.plan import build_comm_plan
    from raptor_tpu_torch.comm.tap import build_tap_plan
    from raptor_tpu_torch.profiling.comm_model import (
        CLASSES, model_comm_plan, model_tap_plan)
    H, L = TAP_LAYOUT
    t0 = time.perf_counter()
    rows = []
    for i, lvl in enumerate(ml.levels):
        plain = model_comm_plan(build_comm_plan(lvl.A), word_bytes, L)
        plan = build_tap_plan(lvl.A, H, L)
        tap = model_tap_plan(plan, word_bytes)
        g = tap.steps["G"].inter_host_bytes
        if not (tap.inter_host_bytes <= plain.inter_host_bytes
                and tap.inter_host_bytes == g
                == plan.dcn_values * word_bytes):
            raise AssertionError(f"comm model level {i}: TAP across hosts "
                                 f"{tap.inter_host_bytes} B, G step {g} B, "
                                 f"plain {plain.inter_host_bytes} B")
        rows.append({"level": i, "plain": {
            "msgs": sum(plain.n_msgs.values()),
            "inter_host_bytes": plain.inter_host_bytes,
            "intra_host_bytes": plain.intra_host_bytes,
            "max_bytes_per_shard": plain.max_bytes_per_shard,
            "max_bytes_per_host_pair": plain.max_bytes_per_host_pair},
            "tap": {"msgs": sum(tap.n_msgs.values()),
                    "inter_host_bytes": tap.inter_host_bytes,
                    "intra_host_bytes": tap.intra_host_bytes,
                    "max_bytes_per_shard": tap.max_bytes_per_shard,
                    "max_bytes_per_host_pair": tap.max_bytes_per_host_pair,
                    "msgs_by_step": {k: sum(st.n_msgs.get(c, 0)
                                            for c in CLASSES)
                                     for k, st in tap.steps.items()}}})
    s = time.perf_counter() - t0
    print(f"18c comm model, 14b on {H} x {L}, {word_bytes}-byte values "
          f"({s:.3f} s): level, plain msgs / bytes across hosts / within, "
          f"TAP the same:")
    for r in rows:
        p, t = r["plain"], r["tap"]
        print(f"  {r['level']:2d}: {p['msgs']:4d} {p['inter_host_bytes']:9d}"
              f" {p['intra_host_bytes']:9d} | {t['msgs']:4d} "
              f"{t['inter_host_bytes']:9d} {t['intra_host_bytes']:9d}")
    return {"layout": [H, L], "word_bytes": word_bytes, "levels": rows,
            "seconds": s}


# phase 19: the real-matrix path, the reference's
# examples/benchmark_nek5000.py flow on the port's stacked shards: an
# operator read from a matrix file, partitioned k-way and its rows
# migrated, its shards placed by the (hosts x shards per host) Topology
# of TAP_LAYOUT, diagonally scaled, set up, checkpointed and reloaded, and
# solved by float64 AMG-preconditioned CG. The operator is the gallery's
# SIPG DG diffusion (penalty DG_SIGMA) at DG_N^2 elements (4 dofs each,
# 1,048,576 rows), written to a .pm file and read back bit for bit (the
# .mtx round trip at DG_MTX_N^2, where MatrixMarket's text stays small);
# its assembly must take less than DG_ASSEMBLY_S. The setup is
# tests/test_fem.py::test_fem_gallery_amg_solves's (RS + modified
# classical, theta 0.25, Chebyshev(2), host engines). The distributed
# repartition (label propagation and the row migration over the in-process
# transport, from a local view of the block partition) must equal
# make_contiguous on the same labels bit for bit, and the k-way labels
# migrated over the transport the global repartition, the checkpoint the
# setup, level by level; PCG to DG_TOL within the JAX package's iterations
# on the same pipeline plus one, its levels and nnz JAX's, and the
# unscaled, unpermuted x's residual on the original operator below
# DG_RESIDUAL. JAX's levels, nnz, shard sizes and iterations, from a CPU
# run of the JAX package at side N:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#   python -c "import sys, tempfile, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.core.topology import Topology, reorder_shards; from \
#   raptor_tpu.core.types import CoarsenType as C, InterpType as I, \
#   RelaxType as R; from raptor_tpu.device.par import make_mesh; from \
#   raptor_tpu.gallery.dg import dg_diffusion; from raptor_tpu.gallery.io \
#   import read_par_pm, write_pm; from raptor_tpu.krylov.cg import cg; from \
#   raptor_tpu.linalg.diag_scale import diagonally_scale; from \
#   raptor_tpu.linalg.repartition import partition_graph, \
#   repartition_matrix; from raptor_tpu.multilevel.checkpoint import \
#   load_hierarchy, save_hierarchy; from \
#   raptor_tpu.multilevel.device_hierarchy import DeviceHierarchy as DH; \
#   from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver \
#   as RS; n = int(sys.argv[1]); d = tempfile.mkdtemp(); write_pm(d + \
#   '/a.pm', dg_diffusion(n, n)); A = read_par_pm(d + '/a.pm', 8); b = \
#   A.mult(np.ones(A.global_num_rows)); A1, p1 = repartition_matrix(A, \
#   partition_graph(A, 8)); A2, p2 = reorder_shards(A1, Topology(8, \
#   ppn=4)); As, bs, s = diagonally_scale(A2, b[p1[p2]]); ml = RS(0.25, \
#   C.RS, I.ModClassical, relax_type=R.Chebyshev); ml.num_smooth_sweeps = \
#   2; ml.rap_mode = ml.interp_mode = 'host'; ml.setup(As); \
#   save_hierarchy(ml, d + '/h'); ml = load_hierarchy(d + '/h'); m = \
#   make_mesh(8); dh = DH(ml, m, dtype=jnp.float64); r = cg(m, \
#   dh.levels[0].A, dh.vector(0 * bs), dh.vector(bs), tol=1e-8, \
#   max_iter=200, precond=dh.precond_pack()); print([l.A.global_num_rows \
#   for l in ml.levels], [l.A.nnz for l in ml.levels], \
#   np.diff(A2.partition.row_bounds).tolist(), int(r.n_iters))" N
# 19g: the DG_CPU_N^2 pipeline solved on the card and with the plain
# versions on the CPU, x within CARD_CPU_TOL of max |x| in the same
# iterations.
DG_N = 512
DG_SIGMA = 10.0
DG_SHARDS = TAP_LAYOUT[0] * TAP_LAYOUT[1]
DG_MTX_N = 128
DG_ASSEMBLY_S = 20.0
DG_TOL = 1e-8
DG_MAX_ITER = 200
DG_RESIDUAL = 1e-7
DG_CPU_N = 32
DG_LEVELS = {512: [1048576, 524288, 261123, 65278, 16256, 4095, 1022, 255,
                   65, 19],
             32: [4096, 2048, 963, 240, 56, 13]}
DG_NNZ = {512: [16492540, 12019742, 5463135, 1360126, 336036, 83695, 19956,
                4781, 1047, 251],
          32: [63100, 44702, 18975, 4394, 868, 121]}
DG_SHARD_ROWS = {512: [120065, 128216, 137234, 136768, 137159, 136056,
                       135613, 117465],
                 32: [470, 505, 528, 484, 532, 538, 538, 501]}
DG_PCG = {512: 10, 32: 10}


def same_csr(what, a, b):
    """Fail unless two CSR matrices are equal bit for bit."""
    if not (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.asarray(a.data).tobytes() == np.asarray(b.data).tobytes()):
        raise AssertionError(f"{what}: not equal bit for bit")


def dg_pipeline(n, tmp, out, full=True):
    """Steps 19a-19d at n^2 elements in directory ``tmp``: the operator
    through a .pm file, the partitions, k-way repartition, topology
    placement, scaling, the setup and its checkpoint; with ``full`` also
    the .mtx round trip, the block and RCM partitions' volumes and the
    distributed repartition. Records seconds and figures in ``out``;
    returns (original A, b = A 1, scaled A, scaled b, scales, perm with
    perm[new] = old, the reloaded hierarchy)."""
    from raptor_tpu_torch.comm.transport import InProcessTransport
    from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
    from raptor_tpu_torch.core.topology import Topology, reorder_shards
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.gallery import io
    from raptor_tpu_torch.gallery.dg import dg_diffusion
    from raptor_tpu_torch.linalg import repartition as rep
    from raptor_tpu_torch.linalg.diag_scale import diagonally_scale
    from raptor_tpu_torch.multilevel import checkpoint
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    s = out.setdefault("seconds", {})

    def step(name, t0):
        s[name] = time.perf_counter() - t0
        return time.perf_counter()

    # 19a: assembly and the file round trips
    t0 = time.perf_counter()
    a = dg_diffusion(n, n, sigma=DG_SIGMA)
    t0 = step("assembly", t0)
    if full and s["assembly"] > DG_ASSEMBLY_S:
        raise AssertionError(f"DG {n}^2 assembly {s['assembly']:.1f} s")
    io.write_pm(tmp / "dg.pm", a)
    t0 = step("write_pm", t0)
    A0 = io.read_par_pm(tmp / "dg.pm", DG_SHARDS)
    t0 = step("read_pm", t0)
    same_csr(f"DG {n}^2 .pm round trip", A0.global_csr, a)
    out.update(rows=a.n_rows, nnz=a.nnz,
               pm_bytes=os.path.getsize(tmp / "dg.pm"))
    del a
    if full:
        small = dg_diffusion(DG_MTX_N, DG_MTX_N, sigma=DG_SIGMA)
        t0 = time.perf_counter()
        io.write_mm(tmp / "dg.mtx", small)
        back = io.read_mm(tmp / "dg.mtx")
        t0 = step("mtx_round_trip", t0)
        if not (np.array_equal(back.indptr, small.indptr)
                and np.array_equal(back.indices, small.indices)):
            raise AssertionError("DG .mtx round trip: another pattern")
        mtx_err = float(np.abs(back.data - small.data).max()
                        / np.abs(small.data).max())
        if mtx_err > 1e-15:
            raise AssertionError(f"DG .mtx round trip: values {mtx_err}")
        out["mtx"] = {"n": DG_MTX_N, "nnz": small.nnz, "rel_err": mtx_err,
                      "bit_equal": back.data.tobytes() == small.data.tobytes(),
                      "bytes": os.path.getsize(tmp / "dg.mtx")}
        print(f"  .mtx round trip at {DG_MTX_N}^2 ({small.nnz} nnz, "
              f"{out['mtx']['bytes']} B): {s['mtx_round_trip']:.3f} s, "
              f"values {mtx_err:.1e} apart (bit for bit: "
              f"{out['mtx']['bit_equal']})", flush=True)
        del small, back
    print(f"DG {n}^2: {out['rows']} rows, {out['nnz']} nnz assembled in "
          f"{s['assembly']:.3f} s; .pm {out['pm_bytes']} B written in "
          f"{s['write_pm']:.3f} s, read into {DG_SHARDS} shards in "
          f"{s['read_pm']:.3f} s, bit for bit", flush=True)

    # 19b: the partitions, the migration, the placement and the scaling
    N = A0.global_num_rows
    b0 = A0.mult(np.ones(N))
    t0 = time.perf_counter()
    kway = rep.partition_graph(A0, DG_SHARDS, method="kway")
    t0 = step("kway", t0)
    vols = {"kway": rep.comm_volume(A0, kway)}
    if full:
        block = np.repeat(np.arange(DG_SHARDS),
                          np.diff(A0.partition.row_bounds))
        vols["block"] = rep.comm_volume(A0, block)
        t0 = time.perf_counter()
        vols["rcm"] = rep.comm_volume(
            A0, rep.partition_graph(A0, DG_SHARDS, method="rcm"))
        t0 = step("rcm", t0)
    out["partitions"] = vols
    print("  partitions into " + str(DG_SHARDS) + ": " + "; ".join(
        f"{k} halo {v['halo_values']}, edge cut {v['edge_cut']}, largest "
        f"{v['max_part_rows']} rows" for k, v in vols.items())
        + f" (k-way {s['kway']:.3f} s)", flush=True)
    t0 = time.perf_counter()
    A1, p1 = rep.repartition_matrix(A0, kway)
    t0 = step("repartition", t0)
    A2, p2 = reorder_shards(A1, Topology(DG_SHARDS, ppn=TAP_LAYOUT[1]))
    perm = p1[p2]
    t0 = step("reorder_shards", t0)
    As, bs, scales = diagonally_scale(A2, b0[perm])
    t0 = step("diagonally_scale", t0)
    out["shard_rows"] = np.diff(A2.partition.row_bounds).tolist()
    print(f"  k-way shards {out['shard_rows']}; repartition "
          f"{s['repartition']:.3f} s, reorder_shards (Topology("
          f"{DG_SHARDS}, ppn={TAP_LAYOUT[1]})) {s['reorder_shards']:.3f} s,"
          f" diagonally_scale {s['diagonally_scale']:.3f} s", flush=True)
    del A2

    # 19c: the distributed repartition from a local view of the block
    # rows: label propagation's labels, then (rows moving between every
    # pair of shards) the k-way labels, each migrated over the transport
    # and equal to the global path's matrix, permutation and bounds
    if full:
        view = ParCSRMatrix.from_local_rows(
            [blk.global_cols_csr(N) for blk in A0.shards()], A0.partition)
        tr = InProcessTransport(view)

        def migrate(what, labels, ref, perm_ref):
            moved, perms = rep.repartition_matrix(view, labels, tr=tr)
            same_csr(f"distributed repartition ({what})",
                     moved.assemble_global(), ref.global_csr)
            if not (np.array_equal(np.concatenate(perms), perm_ref)
                    and np.array_equal(moved.partition.row_bounds,
                                       ref.partition.row_bounds)):
                raise AssertionError(f"distributed repartition ({what}): "
                                     f"another permutation or other bounds")

        t0 = time.perf_counter()
        labels = rep.dist_partition_graph(view, tr)
        t0 = step("label_propagation", t0)
        proc = np.concatenate(labels)
        ref, perm_ref = rep.make_contiguous(A0, proc)
        t0 = time.perf_counter()
        migrate("label propagation", labels, ref, perm_ref)
        t0 = step("dist_repartition", t0)
        rb = A0.partition.row_bounds
        migrate("k-way", [kway[rb[i]:rb[i + 1]] for i in range(DG_SHARDS)],
                A1, p1)
        t0 = step("dist_repartition_kway", t0)
        out["distributed"] = {
            "lp": rep.comm_volume(A0, proc),
            "shard_rows": np.diff(ref.partition.row_bounds).tolist(),
            "moved_rows": int((proc != np.repeat(
                np.arange(DG_SHARDS), np.diff(rb))).sum())}
        print(f"  distributed: label propagation {s['label_propagation']:.3f}"
              f" s ({out['distributed']['moved_rows']} rows moved), its "
              f"row migration {s['dist_repartition']:.3f} s, equal to "
              f"make_contiguous bit for bit; edge cut "
              f"{out['distributed']['lp']['edge_cut']} against the block "
              f"partition's {vols['block']['edge_cut']}, shards "
              f"{out['distributed']['shard_rows']}; the k-way labels' "
              f"migration {s['dist_repartition_kway']:.3f} s, equal to "
              f"repartition_matrix's bit for bit", flush=True)
        del view, tr, ref, labels
    del A1

    # 19d: the setup, its checkpoint and the reload
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.rap_mode = ml.interp_mode = "host"
    t0 = time.perf_counter()
    ml.setup(As)
    t0 = step("setup", t0)
    checkpoint.save_hierarchy(ml, tmp / "ckpt")
    t0 = step("save_hierarchy", t0)
    loaded = checkpoint.load_hierarchy(tmp / "ckpt")
    t0 = step("load_hierarchy", t0)
    if loaded.num_levels != ml.num_levels:
        raise AssertionError("checkpoint: another number of levels")
    for i, (u, v) in enumerate(zip(ml.levels, loaded.levels)):
        if not np.array_equal(u.A.partition.row_bounds,
                              v.A.partition.row_bounds):
            raise AssertionError(f"checkpoint level {i}: other row bounds")
        same_csr(f"checkpoint A{i}", u.A.global_csr, v.A.global_csr)
        if (u.P is None) != (v.P is None):
            raise AssertionError(f"checkpoint level {i}: P")
        if u.P is not None:
            same_csr(f"checkpoint P{i}", u.P.global_csr, v.P.global_csr)
    out.update(levels=[lvl.A.global_num_rows for lvl in loaded.levels],
               level_nnz=[lvl.A.nnz for lvl in loaded.levels],
               level_shard_rows=[np.diff(lvl.A.partition.row_bounds).tolist()
                                 for lvl in loaded.levels])
    print(ml.print_hierarchy())
    print(f"  setup {s['setup']:.3f} s ({ml.num_levels} levels); "
          f"checkpoint saved in {s['save_hierarchy']:.3f} s, reloaded in "
          f"{s['load_hierarchy']:.3f} s, every level's A and P and row "
          f"bounds equal bit for bit", flush=True)
    del ml
    return A0, b0, As, bs, scales, perm, loaded


def dg_held(n, out):
    """Fail unless the pipeline's levels, their nnz and the k-way shard
    sizes at n^2 are the JAX package's."""
    for key, table in (("levels", DG_LEVELS), ("level_nnz", DG_NNZ),
                       ("shard_rows", DG_SHARD_ROWS)):
        want = table[n]
        if out[key] != want:
            raise AssertionError(f"DG {n}^2 {key} {out[key]}, the JAX "
                                 f"package's {want}")


def dg_solve(torch, dh, A0, b0, bs, scales, perm, device="cuda"):
    """19e: float64 AMG-PCG to DG_TOL on the scaled operator; x unscaled
    and put back in the original order. Returns (iterations, residual
    history, x, its relative residual on A0)."""
    from raptor_tpu_torch.krylov.cg import cg
    from raptor_tpu_torch.linalg.diag_scale import diagonally_unscale
    r = cg(dh.levels[0].A, dh.vector(np.zeros_like(bs)), dh.vector(bs),
           tol=DG_TOL, max_iter=DG_MAX_ITER, precond=dh.precond_pack())
    if device == "cuda":
        torch.cuda.synchronize()
    x = np.empty(A0.global_num_rows)
    x[perm] = diagonally_unscale(dh.host(r.x), scales)
    rel = float(np.linalg.norm(b0 - A0.mult(x)) / np.linalg.norm(b0))
    return r.n_iters, np.asarray(r.res), x, rel


def pcg_iteration_launches(torch, dh, bs, k, kernels):
    """The ported kernels' launches of one iteration of the real solve:
    the counts of ``cg`` stopped after j iterations less those of ``cg``
    stopped after j - 1, j the last of its k iterations that recomputes
    no true residual (``cg``'s every 8th)."""
    from raptor_tpu_torch.krylov.cg import cg
    j = max(i for i in range(2, k + 1) if (i - 1) % 8)
    counts = []
    for m in (j, j - 1):
        kernels.reset_launches()
        cg(dh.levels[0].A, dh.vector(np.zeros_like(bs)), dh.vector(bs),
           tol=DG_TOL, max_iter=m, precond=dh.precond_pack())
        torch.cuda.synchronize()
        counts.append(dict(kernels.LAUNCHES))
    return {name: counts[0][name] - counts[1][name] for name in counts[0]}


def pcg_iteration_report(torch, dh, bs, k, kernels):
    """One PCG iteration on the card: the launches of one iteration of the
    real solve (``pcg_iteration_launches``); device ms by CUDA events, the
    host's enqueue ms, the profiler's busy ms and the launches by kernel
    name in a ``device_trace`` (under the git-ignored build/) of
    ``krylov.profile.pcg_step``'s proxy step, which must launch the ported
    kernels as often as that iteration."""
    import collections
    import pathlib

    from raptor_tpu_torch.krylov.profile import pcg_step
    from raptor_tpu_torch.profiling.timers import device_trace
    launches = pcg_iteration_launches(torch, dh, bs, k, kernels)
    step = pcg_step(dh.levels[0].A, dh.precond_pack())
    x = dh.vector(bs)

    def iteration():
        return step(x)

    iteration()
    torch.cuda.synchronize()
    kernels.reset_launches()
    iteration()
    torch.cuda.synchronize()
    proxy = dict(kernels.LAUNCHES)
    if proxy != launches:
        raise AssertionError(f"the proxy PCG step launches {proxy}, an "
                             f"iteration of the solve {launches}")
    t1 = time.perf_counter()
    iteration()
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    ms = time_ms(torch, iteration, reps=10)
    n_kern, busy_ms = device_busy(torch, iteration)
    logdir = pathlib.Path(__file__).resolve().parent / "build" / "trace19"
    with device_trace(str(logdir)) as path:
        iteration()
    by_name = collections.Counter(trace_kernel_names(path))
    print(f"  a PCG iteration (float64): ported-kernel launches {launches} "
          f"in the solve and in the proxy step; the proxy step {ms:.3f} ms "
          f"on the card, host enqueue {enqueue_ms:.3f} ms, {n_kern} kernels "
          f"busy {busy_ms:.3f} ms; the trace's {sum(by_name.values())} "
          f"launches by name, most first: "
          + ", ".join(f"{k[:60]} {v}" for k, v in by_name.most_common(8)),
          flush=True)
    return {"pcg_iteration_ms": ms, "pcg_iteration_enqueue_ms": enqueue_ms,
            "pcg_iteration_kernels": n_kern,
            "pcg_iteration_busy_ms": busy_ms,
            "launches_per_pcg_iteration": launches,
            "trace_launches_by_name": dict(by_name.most_common(40))}


def dg_reference_check(torch, n=DG_CPU_N):
    """19g: the n^2 pipeline (without its full-size extras) solved by
    float64 AMG-PCG on the card and with the plain versions on the CPU:
    the same iterations (JAX's at n), x within CARD_CPU_TOL of max |x|.
    Returns the gap."""
    import pathlib
    import tempfile

    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        A0, b0, As, bs, scales, perm, ml = dg_pipeline(
            n, pathlib.Path(tmp), out, full=False)
    dg_held(n, out)
    got = {}
    for dev in ("cuda", "cpu"):
        dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=128,
                             device=dev)
        got[dev] = dg_solve(torch, dh, A0, b0, bs, scales, perm, dev)
    (kg, _, xg, rg), (kc, _, xc, rc) = got["cuda"], got["cpu"]
    gap = float(np.abs(xg - xc).max() / np.abs(xc).max())
    print(f"reference: DG {n}^2 float64 AMG-PCG, card {kg} / CPU {kc} "
          f"iterations (JAX {DG_PCG[n]}), x apart {gap:.3e} of max |x|, "
          f"residuals {rg:.3e} / {rc:.3e}", flush=True)
    if kg != kc or kc > DG_PCG[n] + 1 or not gap <= CARD_CPU_TOL:
        raise AssertionError(f"DG {n}^2: card {kg}, CPU {kc} iterations "
                             f"(JAX {DG_PCG[n]}), x {gap:.3e} apart")
    return gap


def real_matrix(torch, kernels, by_path, gen, checks, n=DG_N):
    """Phase 19 (see the comment above DG_N): the pipeline at n^2, the
    pack of the reloaded hierarchy, the solve and its launches, one PCG
    iteration's times, the kernels of A0 and P0 against their plain
    versions, and the card-against-CPU check."""
    import pathlib
    import tempfile

    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    out = {"n": n, "sigma": DG_SIGMA, "shards": DG_SHARDS}
    with tempfile.TemporaryDirectory() as tmp:
        A0, b0, As, bs, scales, perm, ml = dg_pipeline(
            n, pathlib.Path(tmp), out)
    s = out["seconds"]
    dg_held(n, out)
    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float64)
    torch.cuda.synchronize()
    s["pack"] = time.perf_counter() - t0
    out["formats"] = dh.format_summary()
    print(f"device hierarchy (float64, lane_pad {dh.lane_pad}): "
          f"{s['pack']:.3f} s")
    print("\n".join(out["formats"]))
    for i, rows in enumerate(out["level_shard_rows"]):
        print(f"  level {i:2d} shards {rows}")

    # 19e: the solve
    kernels.reset_launches()
    t0 = time.perf_counter()
    k, hist, x, rel = dg_solve(torch, dh, A0, b0, bs, scales, perm)
    s["pcg"] = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    by_path["dg_pcg"] = launches
    want = DG_PCG[n]
    print(f"solve (DG {n}^2, float64 AMG-PCG): {k} iterations to "
          f"{hist[k]:.3e} in {s['pcg']:.3f} s (JAX {want}); unscaled "
          f"residual on the original operator {rel:.3e}; launches "
          f"{launches}", flush=True)
    if not (np.isfinite(x).all() and x.shape == (A0.global_num_rows,)):
        raise AssertionError("DG solution is not finite or has the wrong "
                             "shape")
    if (hist[k] > DG_TOL or rel > DG_RESIDUAL
            or k > want + 1):
        raise AssertionError(f"DG {n}^2: {k} iterations to {hist[k]}, "
                             f"residual {rel} (JAX {want})")
    require_launches(f"DG {n}^2 PCG", launches,
                     path_kernels(dh, residual=False))
    out.update(iterations=k, history=hist[:k + 1].tolist(),
               unscaled_rel_residual=rel, launches=launches,
               **pcg_iteration_report(torch, dh, bs, k, kernels))

    # 19f: the kernels of A0 and P0 against their plain versions
    cases = [(FORMAT_KERNEL[M.on_format], f"DG {n}^2 {label}", M, host(),
              embed) for label, M, host, embed in operators(dh, ml)[:2]
             if M.on_format in FORMAT_KERNEL]
    out["checked"] = [c[1] for c in cases]
    del dh
    torch.cuda.empty_cache()
    run_checks(torch, cases, 128, gen, checks)
    del cases

    # 19g: card against CPU
    out["card_cpu_rel_err"] = dg_reference_check(torch)
    print(json.dumps({f"dg_{n}": {k: v for k, v in out.items()
                                  if k not in ("history", "formats")}}))
    return out


# phase 20: the containers and the rest of the host library. 20a: phase 3's
# operator at CONTAINERS_N^2, its triplets (every entry of the port's
# par_stencil_grid split into two exact halves, v/2 + v/2, in a seeded
# scrambled order) assembled by ParCOOMatrix, whose finalize must give the
# stencil matrix bit for bit; aniso_setup's configuration as an AMGConfig,
# carried through to_dict, JSON and from_dict, built and set up: its levels,
# A and P bit-equal to aniso_setup's; a float32 DeviceHierarchy refined to
# 1e-8 with b = A 1 (made and checked through ParVector) in at most the JAX
# package's refinements plus one, DIA and BDIA launched. The JAX package's
# refinements (lane padding 1, float32 hierarchy refined in float64 to
# 1e-8, b = A 1), from a CPU run at side N (2 min at 1024^2):
#   JAX_PLATFORMS=cpu python -c "import sys, numpy as np, jax; \
#   jax.config.update('jax_enable_x64', True); import jax.numpy as jnp; \
#   from raptor_tpu.core.types import CoarsenType as C, InterpType as I, \
#   RelaxType as R; from raptor_tpu.device.par import make_mesh; from \
#   raptor_tpu.gallery.stencils import diffusion_stencil_2d as D, \
#   par_stencil_grid as G; from raptor_tpu.multilevel.device_hierarchy \
#   import DeviceHierarchy as DH; from \
#   raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver as RS; \
#   n = int(sys.argv[1]); A = G(D(0.001, np.pi / 8), (n, n), 1); ml = \
#   RS(0.25, C.RS, I.ModClassical, relax_type=R.Chebyshev); \
#   ml.num_smooth_sweeps = 3; ml.max_levels = 25; ml.rap_mode = \
#   ml.interp_mode = 'host'; ml.setup(A); b = A.mult(np.ones(n * n)); _, h \
#   = DH(ml, make_mesh(1), dtype=jnp.float32, lane_pad=1).solve_mixed(0 * \
#   b, b, tol=1e-8, max_iter=200); print([l.A.global_num_rows for l in \
#   ml.levels], len(h) - 1, h[-1])" N
# 20b: phase 12's Q1 plane-stress elasticity at CONTAINERS_BSR elements,
# its 2 x 2 blocks split into two exact halves and added one by one in a
# seeded scrambled order through ParBCOOMatrix.add_block: finalize must
# give par_fem's matrix bit for bit; ParBSRMatrix.to_device on the card and
# bsr_spmv within CONTAINERS_BSR_TOL of max |y| of the host product in
# float64; a ParBSCMatrix block round trip. 20c: the host oracles,
# tests/test_serial_multilevel.py (SerialMultilevel against the one-shard
# float64 DeviceHierarchy on the card at CONTAINERS_SERIAL_N^2: the same
# cycles, residuals within rtol 1e-5, x within 1e-8) and
# tests/test_external.py (solve_external's scipy CG, preconditioned by the
# host V-cycle of an SSOR hierarchy at CONTAINERS_EXTERNAL_N^2, to 1e-10:
# info 0, the residual below 1e-9, fewer than 30 iterations).
CONTAINERS_N = 1024
CONTAINERS_REFINEMENTS = {1024: 16, 512: 16}
CONTAINERS_BSR = (512, 256)
CONTAINERS_BSR_TOL = 1e-12
# 20a's host products against products summed by other code, relative to
# max |y|: the same order of terms, so a few ulps at most
CONTAINERS_HOST_TOL = 1e-14
CONTAINERS_SERIAL_N = 25
CONTAINERS_EXTERNAL_N = 40
CONTAINERS_EXTERNAL_ITERS = 30


def peak_rss_mib():
    """This process's peak resident set, MiB (``ru_maxrss`` is in KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def same_csr(what, got, want):
    """Two CSRMatrix equal bit for bit: shape, indptr, indices, data."""
    if got.shape != want.shape or not all(
            getattr(got, f).tobytes() == getattr(want, f).tobytes()
            for f in ("indptr", "indices", "data")):
        raise AssertionError(f"{what}: not the same matrix bit for bit")


def containers_flagship(torch, kernels, by_path, seed, steps,
                        n=CONTAINERS_N):
    """20a (see above). Returns its summary with the solve's launches and a
    V-cycle's."""
    from raptor_tpu_torch.core.par_matrix import ParCOOMatrix, ParCSCMatrix
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.core.vector import ParVector
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.utils.config import AMGConfig
    t0 = time.perf_counter()
    S = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n), 1)
    g = S.global_csr
    perm = np.random.default_rng(seed).permutation(2 * g.nnz)
    coo = ParCOOMatrix(S.partition)
    coo.add_values(np.tile(g.row_ids(), 2)[perm], np.tile(g.indices, 2)[perm],
                   np.tile(g.data / 2, 2)[perm])
    A = coo.finalize()
    same_csr(f"ParCOO {n}^2", A.global_csr, g)
    steps["20a assembly"] = time.perf_counter() - t0
    del S, g, perm, coo

    t0 = time.perf_counter()
    cfg = AMGConfig(method="ruge_stuben", strong_threshold=0.25,
                    coarsen_type=CoarsenType.RS,
                    interp_type=InterpType.ModClassical,
                    relax_type=RelaxType.Chebyshev, num_smooth_sweeps=3,
                    max_levels=25, rap_mode="host", interp_mode="host")
    carried = AMGConfig.from_dict(json.loads(json.dumps(cfg.to_dict())))
    if carried != cfg:
        raise AssertionError(f"AMGConfig round trip: {carried} != {cfg}")
    ml = carried.build()
    ml.setup(A)
    steps["20a setup"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, ref = aniso_setup(n)
    steps["20a aniso_setup"] = time.perf_counter() - t0
    levels = [lvl.A.global_num_rows for lvl in ml.levels]
    if levels != [lvl.A.global_num_rows for lvl in ref.levels]:
        raise AssertionError(f"AMGConfig {n}^2: levels {levels}, "
                             f"aniso_setup's "
                             f"{[lvl.A.global_num_rows for lvl in ref.levels]}")
    for i, (lvl, rl) in enumerate(zip(ml.levels, ref.levels)):
        same_csr(f"AMGConfig {n}^2 A{i}", lvl.A.global_csr, rl.A.global_csr)
        if rl.P is not None:
            same_csr(f"AMGConfig {n}^2 P{i}", lvl.P.global_csr,
                     rl.P.global_csr)
    del ref
    print(f"20a: ParCOO {n}^2 ({2 * A.nnz} halves) finalized to the stencil "
          f"matrix bit for bit; AMGConfig through to_dict / JSON / from_dict: "
          f"{len(levels)} levels {levels}, A and P equal aniso_setup's bit "
          f"for bit", flush=True)

    t0 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float32)
    torch.cuda.synchronize()
    steps["20a pack"] = time.perf_counter() - t0
    part = A.partition
    ones = ParVector.zeros(part).set_const_value(1.0)
    b = ParVector(A.mult(ones.values), part)
    norm_err = abs(b.norm() - math.sqrt(math.fsum(b.values ** 2))) / b.norm()
    dot = math.fsum(b.values)
    dot_err = abs(b.inner_product(ones) - dot) / abs(dot)
    if not (norm_err <= 1e-12 and dot_err <= 1e-12):
        raise AssertionError(f"ParVector: norm off by {norm_err}, inner "
                             f"product by {dot_err}")
    t0 = time.perf_counter()
    want = CONTAINERS_REFINEMENTS.get(n)
    k, by_path["2d_containers"], solve_s = drive_solve(
        torch, dh, A, b.values, f"containers {n}^2, b = A 1", kernels,
        limit=None if want is None else want + 1)
    require_launches(f"containers {n}^2", by_path["2d_containers"])
    kernels.reset_launches()
    dh.vcycle(dh.vector(np.zeros(part.global_num_rows)),
              dh.vector(b.values / b.norm()))
    torch.cuda.synchronize()
    per_cycle = dict(kernels.LAUNCHES)
    steps["20a solve"] = time.perf_counter() - t0
    # P0's mult_T (A is symmetric) against P0^T built by
    # ParCSCMatrix.transpose (a row product of the transposed arrays), A's
    # residual against a numpy row sum: neither goes through the scipy
    # product that the port's methods make
    rng = np.random.default_rng(seed)
    P = ml.levels[0].P
    xp = rng.standard_normal(P.partition.global_num_rows)
    yt = ParCSCMatrix(P).transpose().mult(xp)
    err_t = float(np.abs(P.mult_T(xp) - yt).max() / np.abs(yt).max())
    x = rng.standard_normal(part.global_num_cols)
    g = A.global_csr
    rt = b.values - np.add.reduceat(g.data * x[g.indices], g.indptr[:-1])
    err_r = float(np.abs(A.residual(x, b.values) - rt).max()
                  / np.abs(rt).max())
    print(f"20a: ParVector norm / inner product against numpy {norm_err:.3e} "
          f"/ {dot_err:.3e}; {k} refinements (JAX {want}); a V-cycle's "
          f"launches {per_cycle}; ParCSR P0 mult_T against ParCSC's "
          f"transpose / A residual against a numpy row sum {err_t:.3e} / "
          f"{err_r:.3e} of max", flush=True)
    if not (err_t <= CONTAINERS_HOST_TOL and err_r <= CONTAINERS_HOST_TOL):
        raise AssertionError(f"ParCSR mult_T / residual off by {err_t} / "
                             f"{err_r} of max")
    return {"n": n, "levels": levels, "refinements": k, "jax_refinements": want,
            "solve_s_first": solve_s, "launches": by_path["2d_containers"],
            "launches_per_vcycle": per_cycle, "vector_norm_rel_err": norm_err,
            "vector_dot_rel_err": dot_err, "mult_T_rel_err": err_t,
            "residual_rel_err": err_r}


def containers_blocked(torch, seed, steps, size=CONTAINERS_BSR):
    """20b (see above): the blocked assembly, the card's block SpMV and the
    BSC round trip."""
    from raptor_tpu_torch.core.matrix import BSRMatrix
    from raptor_tpu_torch.core.par_matrix import ParBCOOMatrix, ParBSCMatrix
    from raptor_tpu_torch.device.bsr import bsr_spmv
    from raptor_tpu_torch.device.par import device_put_vector, host_vector
    from raptor_tpu_torch.gallery.fem import par_fem
    nx, ny = size
    t0 = time.perf_counter()
    K, _ = par_fem("elasticity", nx, ny, 1)
    blocks = BSRMatrix.from_csr(K.global_csr, 2, 2)
    rows = np.repeat(np.arange(blocks.n_block_rows), np.diff(blocks.indptr))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(2 * len(rows))
    coo = ParBCOOMatrix(K.partition, 2)
    for r, c, blk in zip(np.tile(rows, 2)[perm].tolist(),
                         np.tile(blocks.indices, 2)[perm].tolist(),
                         np.tile(blocks.blocks / 2, (2, 1, 1))[perm]):
        coo.add_block(r, c, blk)
    pb = coo.finalize()
    same_csr(f"ParBCOO {nx} x {ny}", pb.par_csr.global_csr, K.global_csr)
    steps["20b assembly"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dA = pb.to_device("cuda")
    x = rng.standard_normal(K.global_num_cols)
    y = bsr_spmv(dA, device_put_vector(x, pb.partition.col_bounds,
                                       dA.bcols_pad * 2, device="cuda"))
    torch.cuda.synchronize()
    ref = pb.mult(x)
    err = float(np.abs(host_vector(y, pb.partition.row_bounds) - ref).max()
                / np.abs(ref).max())
    steps["20b to_device + bsr_spmv"] = time.perf_counter() - t0
    back, want = ParBSCMatrix(pb).local_bsc(0).to_bsr(), pb.local_bsr(0)
    bsc_equal = all(getattr(back, f).tobytes() == getattr(want, f).tobytes()
                    for f in ("indptr", "indices", "blocks"))
    print(f"20b: ParBCOO {nx} x {ny} ({2 * len(rows)} half blocks) finalized "
          f"to par_fem's matrix bit for bit; bsr_spmv on the card against "
          f"the host product {err:.3e} of max |y|; ParBSC round trip "
          f"{'equal' if bsc_equal else 'NOT equal'}", flush=True)
    if not (err <= CONTAINERS_BSR_TOL and bsc_equal):
        raise AssertionError(f"20b: bsr_spmv off by {err}, BSC round trip "
                             f"equal {bsc_equal}")
    return {"size": [nx, ny], "half_blocks": 2 * len(rows),
            "bsr_spmv_rel_err": err}


def containers_oracles(torch, steps):
    """20c (see above): SerialMultilevel against the card, solve_external."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType, RelaxType
    from raptor_tpu_torch.external import solve_external
    from raptor_tpu_torch.gallery.stencils import (
        diffusion_stencil_2d, par_stencil_grid)
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    from raptor_tpu_torch.multilevel.serial import SerialMultilevel

    def setup(n, **kw):
        A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n),
                             1)
        ml = ParRugeStubenSolver(0.25, **kw)
        ml.rap_mode = ml.interp_mode = "host"
        ml.setup(A)
        return A, ml, A.mult(np.ones(n * n))

    t0 = time.perf_counter()
    A, ml, b = setup(CONTAINERS_SERIAL_N, coarsen_type=CoarsenType.CLJP,
                     interp_type=InterpType.ModClassical)
    sx, sres, sit = SerialMultilevel(ml).solve(np.zeros_like(b), b)
    dh = DeviceHierarchy(ml)
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    x_err = float(np.abs(dh.host(r.x) - sx).max())
    res_err = float(np.max(np.abs(r.res[:sit + 1] - sres) / sres))
    steps["20c serial"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A, ml, b = setup(CONTAINERS_EXTERNAL_N, relax_type=RelaxType.SSOR)
    x, info, iters = solve_external(ml, b, solver="cg", tol=1e-10)
    rel = float(np.linalg.norm(b - A.mult(x)) / np.linalg.norm(b))
    steps["20c solve_external"] = time.perf_counter() - t0
    print(f"20c: SerialMultilevel {CONTAINERS_SERIAL_N}^2 {sit} cycles, the "
          f"card's {r.n_iters}; residuals within {res_err:.3e} (relative), "
          f"x within {x_err:.3e}; solve_external cg "
          f"{CONTAINERS_EXTERNAL_N}^2: info {info}, {iters} iterations, "
          f"residual {rel:.3e}", flush=True)
    if not (r.n_iters == sit and res_err <= 1e-5 and x_err <= 1e-8):
        raise AssertionError(f"20c: SerialMultilevel {sit} cycles against "
                             f"the card's {r.n_iters}, residuals {res_err}, "
                             f"x {x_err}")
    if not (info == 0 and rel < 1e-9 and iters < CONTAINERS_EXTERNAL_ITERS):
        raise AssertionError(f"20c: solve_external info {info}, {iters} "
                             f"iterations, residual {rel}")
    return {"serial_cycles": sit, "serial_res_rel_err": res_err,
            "serial_x_err": x_err, "external_cg_iterations": iters,
            "external_cg_rel_residual": rel}


def containers(torch, kernels, by_path, seed):
    """20: the containers and the host library (see above), each step's
    seconds and the process's peak resident set."""
    steps = {}
    out = {"flagship": containers_flagship(torch, kernels, by_path, seed,
                                           steps)}
    torch.cuda.empty_cache()
    out["blocked"] = containers_blocked(torch, seed, steps)
    out["oracles"] = containers_oracles(torch, steps)
    out["steps_s"] = steps
    out["peak_rss_mib"] = peak_rss_mib()
    print("20: " + ", ".join(f"{k} {v:.3f} s" for k, v in steps.items())
          + f"; peak RSS {out['peak_rss_mib']:.1f} MiB", flush=True)
    return out


# phase 21: the twins of the JAX package's example scripts
# (examples_torch/), each's main called on the card at its script's default
# arguments: (twin, arguments). benchmark_tap_amg.py runs at EX_TAP_N^2 in
# place of its 512^2, whose flow phase 14a runs (its float32 SOR cycle there
# takes about 450 ms, and the twin solves 11 times).
EX_TAP_N = 64
# the matrix files of the twins that read one (the JAX scripts' defaults
# lie in the reference's tree), written into the phase's temporary directory
# ("{tmp}" in an argument): the flagship's operator at 256^2 and phase 19's
# SIPG DG operator (penalty DG_SIGMA) at 64^2 elements, 16,384 rows.
# benchmark_setup_engines.py runs at EX_ENGINES_N^3 in place of its 128^3
# (phase 13 sets up 80^3 on the card's engines), benchmark_spmv_sweep.py
# without its 96^3: both cut for the script's time (64^3 and the sweep's
# 96^3 took about 12 s more on an H100).
EX_READER_N = 256
EX_DG_N = 64
# benchmark_setup_sweeps.py at EX_SWEEPS_N^2 in place of its 64^2 and
# profile_amg.py at EX_PROFILE_AMG_N^2 in place of its 512^2: cut for the
# script's time once the last seven twins joined the phase (on a slower
# card machine the two took 44 and 24 s at their defaults)
EX_SWEEPS_N = 48
EX_PROFILE_AMG_N = 256
EX_ENGINES_N = 48
EX_SWEEP_SIZES = (32, 48, 64)
EXAMPLES = (("example", ()), ("coo_csr_example", ()),
            ("matop_example", ()), ("benchmark_amg", ()),
            ("benchmark_pcg", ()), ("profile_pcg", ()),
            ("profile_amg", (str(EX_PROFILE_AMG_N),)),
            ("benchmark_gmres", ()), ("benchmark_solve", ()),
            ("benchmark_sa", ()), ("benchmark_setup_sweeps", (str(EX_SWEEPS_N),)),
            ("benchmark_bsr_amg", ()), ("benchmark_setup", ()),
            ("benchmark_spgemm", ()), ("benchmark_spmv", ()),
            ("benchmark_tap_spmv", ()),
            ("benchmark_tap_amg", (str(EX_TAP_N),)),
            ("model_tap_steps", ()), ("profile_comm_levels", ()),
            ("run_multiproc_setup", ()),
            ("benchmark_reader", (f"{{tmp}}/aniso{EX_READER_N}.pm",)),
            ("benchmark_nek5000", (f"{{tmp}}/dg{EX_DG_N}.mtx",)),
            ("benchmark_tap_setup", ()),
            ("benchmark_setup_engines", (str(EX_ENGINES_N), "3", "PMIS",
                                         "Extended")),
            ("benchmark_transfer_formats", ("48", "{tmp}")),
            ("benchmark_spmv_sweep", ("f64", *map(str, EX_SWEEP_SIZES))),
            ("benchmark_spmv_overlap", ()))
# the twins that run on the host only, in both packages (the setup's device
# engines are torch ops): every other twin launches a ported kernel
EX_HOST_ONLY = {"matop_example", "benchmark_setup", "benchmark_spgemm",
                "model_tap_steps", "run_multiproc_setup",
                "benchmark_tap_setup", "benchmark_setup_engines"}
# the kernels a twin's path must launch, each at least once
EX_REQUIRES = {"benchmark_reader": ("dia_spmv",),
               "benchmark_transfer_formats": (
                   "wind_ell_spmv", "swellt_spmv_T", "bell_spmv")}
# the JAX scripts' iteration counts at the same arguments on the CPU, which
# the twins' counts may pass by one at most (the card's SOR adds with
# atomics, and its float32 sums in its own order), from
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#   python examples/<script>.py [arguments]
# run from the repository root (tens of minutes on a CPU, most of them
# benchmark_pcg.py's 2 x 20,000 plain CG iterations and the compiles of
# profile_pcg.py and benchmark_tap_amg.py). benchmark_gmres.py with
# JAX_ENABLE_X64=1: the script leaves JAX's 64-bit mode off, and in float32
# its 1e-8 lies below the rounding (65 and 17 iterations there, the
# rounding's); the twin runs float64. benchmark_pcg.py's plain CG stops at
# its cap in float32 (20,000). profile_amg.py's float32 solve (256) stalls
# just above its 1e-6 in both packages (JAX at its cap of 100 cycles at
# 1.165e-6, the port on the CPU at 1.183e-6 after 50, where its stall guard
# ends it once four cycles in a row gain less than 0.1%), on a plateau
# where the rounding sets each step, so its count is the rounding's. It is
# held to the cycles to 1e-5, above the plateau (JAX: 12; EX_CYCLES_TO; 11
# at 512^2), and printed beside JAX's 100. benchmark_setup_sweeps.py runs
# at 48. benchmark_nek5000.py reads the DG file that example_inputs
# writes, made for the JAX script by
#   python -c "import sys; from raptor_tpu.gallery.dg import dg_diffusion; \
#   from raptor_tpu.gallery.io import write_mm; n = int(sys.argv[1]); \
#   write_mm(f'dg{n}.mtx', dg_diffusion(n, n, 10.0))" 64
# and run as examples/benchmark_nek5000.py dg64.mtx (4 shards); the other
# new twins' scripts as benchmark_setup_engines.py 48 3 PMIS Extended,
# benchmark_spmv_sweep.py f64 32 48 64 and benchmark_tap_setup.py (48 4
# 2). benchmark_nek5000.py's SOR(1) preconditioner (the default
# hierarchy's) is not symmetric, and PCG stops at its cap of 200
# iterations at 3.432e-05 in both packages on the CPU, so its final
# residual is held too (EX_FINAL_RES). The counts of the host setup and
# the host-only twins, the same on every machine, are held exactly
# (EXAMPLE_EXACT): the TAP setup's sends across nodes and levels, the
# nek5000 partitions' halo values and edge cuts and its hierarchy, the
# engines' interpolation pattern and nnz, the sweep's format of each size;
# and the overlap's two orders bit-equal.
EX_CYCLES_TO = {"profile_amg": 1e-5}
EXAMPLE_HOLDS = {
    "example": {"iterations": 23},
    "benchmark_amg": {"iterations": 23},
    "benchmark_pcg": {"cg_iterations": 20000, "pcg_iterations": 7},
    "profile_pcg": {"pcg_iterations": 7},
    "profile_amg": {"cycles_to_1e-05": 12},
    "benchmark_gmres": {"gmres_iterations": 46, "amg_gmres_iterations": 11},
    "benchmark_solve": {"iterations": 7},
    "benchmark_sa": {"iterations": 13},
    "benchmark_setup_sweeps": {"sweeps": [
        {"flat": 228, "TAP": 228}, {"flat": 86, "TAP": 86},
        {"flat": 77, "TAP": 77}, {"flat": 57, "TAP": 57}]},
    "benchmark_bsr_amg": {"iterations": 34, "pcg_iterations": 25},
    "benchmark_tap_amg": {"plain": 16, "tap": {k: 16 for k in range(6)}},
    "benchmark_nek5000": {"pcg_iterations": 200},
}
EXAMPLE_EXACT = {
    "benchmark_tap_setup": {
        "flat": {"inter_node_sends": 880, "levels": 5},
        "tap": {"inter_node_sends": 220, "levels": 5}},
    "benchmark_nek5000": {
        "halo_values": {"naive": 1536, "rcm": 1242, "kway": 1402},
        "edge_cut": {"naive": 4608, "rcm": 7288, "kway": 5480},
        "levels": [[16384, 259072], [8192, 183582], [3971, 80863],
                   [989, 19473], [240, 4406], [56, 866], [16, 180]]},
    "benchmark_setup_engines": {"pattern_eq": True, "p_nnz": 971348},
    "benchmark_spmv_sweep": {"sizes": {n: {"format": "dia"}
                                       for n in EX_SWEEP_SIZES}},
    "benchmark_spmv_overlap": {"bit_equal": True},
}
# the final relative residual of a twin's float64 solve, held to the JAX
# script's on the CPU at ``rtol``, where an iteration count alone cannot
# fail: nek5000's PCG stops at its cap of 200 in both packages. JAX's value
# from the recorded history of benchmark_nek5000.py dg64.mtx (the command
# above, recorded by tests/_torch_examples.py:run_jax). The card's sound
# runs gave 3.431756999684617e-05 (1.3e-12 from JAX's), the port on the
# CPU 1.9e-12 at most along the whole history; the same solve in float32
# lands 1.8e-3 away, so 1e-6 (the CPU tests' same_history) tells a sound
# float64 solve from a wrong one with room on both sides.
EX_FINAL_RES = {"benchmark_nek5000": (3.4317569996802406e-05, 1e-6)}
PHASE_COUNT = 21
# the phases whose objects a phase uses, run with it when it is selected
NEEDS = {4: (3,), 5: (3,), 7: (6,), 8: (6,), 9: (6, 8),
         13: (5, 7, 11), 15: (14,), 16: (15,), 17: (15, 16),
         18: (10, 12)}


def select_phases(spec=None):
    """The phases ``--phases`` selects, in order: the numbers and ranges
    of ``spec`` ("3-5,21"; None: every phase), the phases they need
    (``NEEDS``, transitively) and phases 1 and 2. Raises ValueError for a
    malformed selection or an unknown phase."""
    if spec is None:
        return list(range(1, PHASE_COUNT + 1))
    want = set()
    for part in spec.split(","):
        m = re.fullmatch(r"\s*(\d+)\s*(?:-\s*(\d+)\s*)?", part)
        if m is None:
            raise ValueError(f"phase selection {spec!r}: {part!r} is not a "
                             f"phase number or a range like 3-5")
        lo, hi = int(m[1]), int(m[2] or m[1])
        if not 1 <= lo <= hi <= PHASE_COUNT:
            raise ValueError(f"phase selection {spec!r}: the phases are 1 "
                             f"to {PHASE_COUNT}")
        want.update(range(lo, hi + 1))
    todo = sorted(want)
    while todo:
        for q in NEEDS.get(todo.pop(), ()):
            if q not in want:
                want.add(q)
                todo.append(q)
    return sorted(want | {1, 2})


def phase_list(spec):
    """``select_phases`` for argparse: a bad selection is a usage error."""
    try:
        return select_phases(spec)
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e)) from None


def held(what, got, want):
    """Raise unless every count of ``want`` (nested dicts and lists of
    ints) is matched in ``got`` by a count no more than one above it."""
    if isinstance(want, dict):
        for k, v in want.items():
            held(f"{what}.{k}", got[k], v)
    elif isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} runs, the JAX "
                                 f"script's {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            held(f"{what}[{i}]", g, w)
    elif got > want + 1:
        raise AssertionError(f"{what}: {got} iterations, the JAX script's "
                             f"{want} + 1 at most")


def final_res_held(what, residuals, want, rtol):
    """Raise unless the last of ``residuals`` is within ``rtol`` (relative)
    of ``want``."""
    got = float(residuals[-1])
    if not abs(got - want) <= rtol * want:
        raise AssertionError(f"{what}: final relative residual {got!r}, "
                             f"the JAX script's {want!r} (rtol {rtol})")


def exact(what, got, want):
    """Raise unless every count of ``want`` (nested dicts) equals ``got``'s
    (tuples read as lists)."""
    for k, v in want.items():
        if isinstance(v, dict):
            exact(f"{what}.{k}", got[k], v)
        elif json.loads(json.dumps(got[k])) != v:
            raise AssertionError(f"{what}.{k}: {got[k]}, the JAX script's "
                                 f"{v}")


def example_inputs(tmp):
    """Write the matrix files of the twins that read one into ``tmp``;
    returns their sizes in bytes."""
    from raptor_tpu_torch.gallery import io
    from raptor_tpu_torch.gallery.dg import dg_diffusion
    from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                                   stencil_grid)
    n = EX_READER_N
    io.write_pm(os.path.join(tmp, f"aniso{n}.pm"), stencil_grid(
        diffusion_stencil_2d(0.001, np.pi / 8), (n, n)))
    io.write_mm(os.path.join(tmp, f"dg{EX_DG_N}.mtx"),
                dg_diffusion(EX_DG_N, EX_DG_N, sigma=DG_SIGMA))
    return {f: os.path.getsize(os.path.join(tmp, f))
            for f in sorted(os.listdir(tmp))}


def brief(counts):
    """A twin's counts for the log: every history as its length and last
    value."""
    out = {}
    for k, v in counts.items():
        if isinstance(v, dict):
            v = brief(v)
        elif isinstance(v, list) and k.endswith("residuals"):
            v = {"n": len(v), "last": v[-1] if v else None}
        elif isinstance(v, list):
            v = [brief(x) if isinstance(x, dict) else x for x in v]
        out[k] = v
    return out


def examples_phase(torch, kernels, by_path):
    """Phase 21: every twin of ``EXAMPLES`` in turn, its launches under
    ``by_path["example_<twin>"]``; returns each one's arguments, seconds,
    counts and launches."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke21_") as tmp:
        t0 = time.perf_counter()
        files = example_inputs(tmp)
        print(f"[21] matrix files {files} in "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        for name, args in EXAMPLES:
            args = [a.format(tmp=tmp) for a in args]
            out[name] = run_twin(torch, kernels, by_path, name, args)
            out[name]["args"] = [a.replace(tmp, "{tmp}") for a in args]
    return out


def run_twin(torch, kernels, by_path, name, args):
    """One twin of phase 21 on the card: its seconds, counts and launches,
    held as ``examples_phase`` says."""
    import importlib
    mod = importlib.import_module(f"examples_torch.{name}")
    print(f"[21] examples_torch/{name}.py {' '.join(args)}", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = mod.main([*args, "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = by_path[f"example_{name}"] = dict(kernels.LAUNCHES)
    if counts["launches"] != launches:
        raise AssertionError(f"{name}: its launches {counts['launches']}"
                             f", the wrappers' counts {launches}")
    if name in EX_CYCLES_TO:
        tol = EX_CYCLES_TO[name]
        res = counts["residuals"]
        counts[f"cycles_to_{tol:.0e}"] = next(
            (k for k, r in enumerate(res) if r <= tol), len(res))
    if name in EXAMPLE_HOLDS:
        held(name, counts, EXAMPLE_HOLDS[name])
    if name in EXAMPLE_EXACT:
        exact(name, counts, EXAMPLE_EXACT[name])
    if name in EX_FINAL_RES:
        final_res_held(name, counts["residuals"], *EX_FINAL_RES[name])
    if name not in EX_HOST_ONLY and not any(launches.values()):
        raise AssertionError(f"{name} launched no ported kernel")
    require_launches(name, launches, EX_REQUIRES.get(name, ()))
    print(f"[21] {name}: {secs:.3f} s; counts "
          f"{json.dumps(brief({k: v for k, v in counts.items() if k != 'launches'}))}; "
          f"launches {launches}", flush=True)
    torch.cuda.empty_cache()
    return {"seconds": secs, "counts": brief(counts), "launches": launches}


def twin_figures(twins):
    """The overlap's gain, the L2 sweep's rates and the transfer formats'
    ms an apply from phase 21's twins, for its JSON line."""
    ov = twins["benchmark_spmv_overlap"]["counts"]
    sw = twins["benchmark_spmv_sweep"]["counts"]
    tf = twins["benchmark_transfer_formats"]["counts"]
    return {
        "overlap": {"overlapped_us": ov["overlapped_s"] * 1e6,
                    "serialized_us": ov["serialized_s"] * 1e6,
                    "gain_pct": ov["gain_pct"]},
        "l2_sweep": {
            "l2_bytes": sw["l2_bytes"], "flush_mb": sw["flush_mb"],
            "flush_us": sw["flush_s"] * 1e6,
            "sizes": {n: {k: v[k] for k in ("format", "packed_mb",
                                             "resident_gnnz_s",
                                             "cleared_gnnz_s")}
                      for n, v in sw["sizes"].items()}},
        "transfer_ms": {op: {f: [r["format"], r["ms"]]
                             for f, r in tf[op].items()}
                        for op in ("P", "Pt")}}


# the overlap twin's operator, traced for OV_TRACE_K products of each order
OV_TRACE_N, OV_TRACE_K = 64, 20
# the Chrome trace's categories of host calls into CUDA and of device work
HOST_API = ("cuda_runtime", "cuda_driver")
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_us(spans):
    """Microseconds that the union of the ``(start, end)`` spans covers."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def overlap_trace(torch):
    """Phase 21: where ``spmv_overlap``'s time goes beside ``spmv``'s, on
    the overlap twin's operator (the float32 27-point operator at
    OV_TRACE_N^3 over 8 stacked shards). For each order, a chain of
    OV_TRACE_K products of one x, each a microsecond figure a product:
    ``wall_us`` (the chain behind a synchronize, host clock),
    ``enqueue_us`` (the chain's calls alone, no synchronize: what the host
    takes to hand a product over), and under ``torch.profiler``: the host's
    calls into CUDA but the closing synchronize (``api_calls``, ``api_us``,
    ``api_by_name``), the device's work (``device_ops``; ``busy_us``, the
    union of its spans across streams; ``span_us``, first start to last
    end) and ``gap_us = span_us - busy_us``, the time the device waits;
    ``complete`` is false where the trace holds fewer device records than
    kernel launches (the profiler dropped some: its device figures are then
    short)."""
    import shutil
    import tempfile
    from raptor_tpu_torch.device import par as dpar
    from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                                   par_stencil_grid)
    from raptor_tpu_torch.profiling.timers import device_trace
    t0 = time.perf_counter()
    n, k = OV_TRACE_N, OV_TRACE_K
    A = par_stencil_grid(laplace_stencil_27pt(), (n, n, n), 8)
    dA = dpar.device_put_matrix(A, dtype=torch.float32, lane_pad=128,
                                device="cuda")
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(A.global_num_cols),
        A.partition.col_bounds, dA.cols_pad, dtype=torch.float32,
        device="cuda")
    orders = {"overlapped": dpar.spmv_overlap, "serialized": dpar.spmv}
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke21_trace_")
    try:
        for name, op in orders.items():
            def chain():
                for _ in range(k):
                    op(dA, x)
            chain()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            chain()
            t_enq = time.perf_counter() - t1
            torch.cuda.synchronize()
            t_wall = time.perf_counter() - t1
            with device_trace(tmp) as path:
                chain()
            with open(path) as f:
                ev = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
            # the synchronize that closes the trace waits for the device:
            # it is no cost of a product's enqueue
            api = [e for e in ev if e.get("cat") in HOST_API
                   and "Synchronize" not in e.get("name", "")]
            dev = [(e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") in DEVICE_WORK]
            if not dev:
                raise AssertionError(f"overlap trace ({name}): the "
                                     f"profiler recorded no device work")
            by_name = {}
            for e in api:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
            span = max(b for _, b in dev) - min(a for a, _ in dev)
            busy = busy_us(dev)
            launched = sum(e["name"] == "cudaLaunchKernel" for e in api)
            out[name] = {
                "wall_us": t_wall / k * 1e6, "enqueue_us": t_enq / k * 1e6,
                "api_calls": len(api) / k,
                "api_us": sum(e["dur"] for e in api) / k,
                "api_by_name": {m: v / k for m, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])},
                "device_ops": len(dev) / k, "busy_us": busy / k,
                "span_us": span / k, "gap_us": (span - busy) / k,
                "complete": len(dev) >= launched}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    for name in orders:
        r = out[name]
        print(f"[21] overlap trace, {name} ({n}^3, 8 shards, float32; us "
              f"a product over {k}): wall {r['wall_us']:.1f}, enqueue "
              f"{r['enqueue_us']:.1f}; traced: {r['api_calls']:.1f} CUDA "
              f"calls {r['api_us']:.1f}, {r['device_ops']:.1f} device ops "
              f"busy {r['busy_us']:.1f} of span {r['span_us']:.1f} (gaps "
              f"{r['gap_us']:.1f}; complete {r['complete']}); calls by name "
              f"{ {m: round(v, 1) for m, v in r['api_by_name'].items()} }",
              flush=True)
    print(f"[21] overlap trace in {out['seconds']:.3f} s", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048, help="2-D grid side")
    ap.add_argument("--n3", type=int, default=128,
                    help="3-D grid side (phases 6-9)")
    ap.add_argument("--card-n3", type=int, default=80,
                    help="3-D grid side of phase 13's setup on the card")
    ap.add_argument("--nk", type=int, default=128,
                    help="grid side of the 2-D SOR and Krylov phase")
    ap.add_argument("--sa", type=int, nargs=2, default=[128, 64],
                    metavar=("N_WELL", "N_WELLT"),
                    help="grid sides of the smoothed-aggregation phase: "
                    "windowed ELL and BDIA are checked on the first one's "
                    "operators, the sorted scatter on the second's")
    ap.add_argument("--bsr", type=int, nargs=2, default=[1024, 512],
                    metavar=("NX", "NY"),
                    help="elements of the blocked-AMG phase's full size "
                    "(it also runs bench.py's 128 x 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", type=phase_list, default=select_phases(),
                    help="the phases to run, as numbers and ranges "
                    "(3-5,21; default: all); 1 and 2 always run, and a "
                    "phase brings the phases whose objects it uses")
    args = ap.parse_args(argv)
    run = set(args.phases)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    try:
        from raptor_tpu_torch import native
        from raptor_tpu_torch.device import kernels
        from raptor_tpu_torch.multilevel.device_hierarchy import (
            DeviceHierarchy)
    except ImportError as e:
        print(f"chip_smoke: the raptor_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, n3 = args.n, args.n3
    t_start = time.perf_counter()
    print(f"phases {args.phases}", flush=True)

    # 1. card
    t0 = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"card: {kind} | {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    src = torch.empty(1 << 28, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = time_ms(torch, lambda: dst.copy_(src), reps=10)
    copy_gbs = 2 * src.numel() * 4 / (copy_ms * 1e-3) / 1e9
    del src, dst
    print(f"device-to-device copy: {copy_gbs:.1f} GB/s (read + write)")
    phase("card", t0)

    # 2. build
    t0 = time.perf_counter()
    build(native, kernels)
    phase("build", t0)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    checks = {}
    by_path = {}
    # each phase's summary, by the key of the final JSON line
    S = {}
    prof = {}

    if 3 in run:
        # 3. 2-D setup (host), then the device hierarchy. The setup keeps
        # its large buffers in the heap arena (``pin_arena``, which the
        # stencil assembly calls first; called here too for the value it
        # returns)
        t0 = time.perf_counter()
        from raptor_tpu_torch.utils.hostmem import pin_arena
        arena = pin_arena()
        A, ml = aniso_setup(n)
        setup_s = time.perf_counter() - t0
        print(ml.print_hierarchy())
        if n == 2048 and ml.num_levels != 14:
            raise AssertionError(f"{ml.num_levels} levels at 2048^2, want "
                                 f"14")
        print(f"setup: {ml.num_levels} levels in {setup_s:.3f} s")
        t1 = time.perf_counter()
        dh = DeviceHierarchy(ml, dtype=torch.float32)
        torch.cuda.synchronize()
        print(f"device hierarchy (float32, lane_pad {dh.lane_pad}): "
              f"{time.perf_counter() - t1:.3f} s")
        print("\n".join(dh.format_summary()))
        # the 2-D operators keep the structural picks: DIA or BDIA
        # throughout
        off = [o[0] for o in operators(dh, ml)
               if o[1].on_format not in ("dia", "bdia")]
        if off:
            raise AssertionError(f"2-D operators off DIA/BDIA: {off}")
        rss3 = peak_rss_mib()
        print(f"host arena pinned: {arena}; peak RSS after the 2-D setup "
              f"and pack {rss3:.1f} MiB")
        summary2 = S["2d"] = {"n": n, "levels": ml.num_levels,
                              "setup_s": setup_s,
                              "setup_phase_totals": dict(
                                  ml.setup_times.times),
                              "arena": arena, "peak_rss_mib": rss3}
        phase("setup", t0)

    if 4 in run:
        # 4. kernels against their plain versions on the real operators
        # (float32: the main path's own operators; float64: the same host
        # matrices packed in float64)
        t0 = time.perf_counter()
        label, M, host, embed = largest(dh, ml, "bdia")
        run_checks(torch, [("dia_spmv", "A0", dh.levels[0].A,
                            ml.levels[0].A, None),
                           ("bdia_spmv", label, M, host, embed)],
                   dh.lane_pad, gen, checks)
        del M, host
        phase("kernels", t0)

    if 5 in run:
        # 5. the 2-D main path: mixed-precision solve to 1e-8
        t0 = time.perf_counter()
        x_true = np.random.default_rng(args.seed).standard_normal(n * n)
        b = A.mult(x_true)
        k2, by_path["2d_solve"], _ = drive_solve(torch, dh, A, b, "2-D",
                                                 kernels, limit=20)
        t1 = time.perf_counter()
        dh.solve_mixed(np.zeros(n * n), b, tol=1e-8, max_iter=100,
                       return_device=True)
        print(f"solve (warm): in {time.perf_counter() - t1:.3f} s")
        # the right-hand side of the JAX package's record (b = A 1: 15
        # refinements at 2048^2, BASELINE_RESULTS.md)
        b1 = A.mult(np.ones(n * n))
        _, hist1 = dh.solve_mixed(np.zeros(n * n), b1, tol=1e-8,
                                  max_iter=100, return_device=True)
        print(f"solve (b = A 1): {len(hist1) - 1} refinements to "
              f"{hist1[-1]:.3e}")
        if hist1[-1] > 1e-8 or len(hist1) - 1 > 20:
            raise AssertionError(f"b = A 1: no 1e-8 within 20: {hist1}")
        cyc2 = cycle_report(torch, dh, b, kernels)
        prof["2d"] = profile_levels(torch, dh, f"2-D {n}^2", cyc2)
        k, res = reference_check(torch, aniso_setup, 64,
                                 lambda m: np.random.default_rng(1)
                                 .standard_normal(m))
        print(f"reference: 64^2 float64 solve, card == CPU plain versions "
              f"({k} cycles to {res:.3e})")
        summary2.update(solve_refinements=k2,
                        solve_refinements_ones=len(hist1) - 1, **cyc2)
        del b, b1
        phase("solve", t0)
    if 3 in run:
        del dh, ml, A
        torch.cuda.empty_cache()

    if 6 in run:
        # 6. 3-D setup (host), then the device hierarchy
        t0 = time.perf_counter()
        A3, ml3 = lap27_setup(n3)
        setup3_s = time.perf_counter() - t0
        print(ml3.print_hierarchy())
        print(f"3-D setup: {ml3.num_levels} levels in {setup3_s:.3f} s")
        t1 = time.perf_counter()
        dh3 = DeviceHierarchy(ml3, dtype=torch.float32)
        torch.cuda.synchronize()
        pack3_s = time.perf_counter() - t1
        print(f"3-D device hierarchy (float32, lane_pad {dh3.lane_pad}): "
              f"{pack3_s:.3f} s")
        formats3 = dh3.format_summary()
        print("\n".join(formats3))
        rss6 = peak_rss_mib()
        print(f"peak RSS after the 3-D setup and pack {rss6:.1f} MiB")
        summary3 = S["3d"] = {
            "size": n3, "levels": ml3.num_levels, "setup_s": setup3_s,
            "setup_phase_totals": dict(ml3.setup_times.times),
            "n3": n3, "pack_s": pack3_s, "peak_rss_mib": rss6,
            "formats": formats3}
        phase("3-D setup", t0)

    if 7 in run:
        # 7. the 3-D main path: b = A 1 (the JAX package's record:
        # BENCH_r02.json), then a random x_true
        t0 = time.perf_counter()
        N3 = n3 ** 3
        b3 = A3.mult(np.ones(N3))
        k3, by_path["3d_solve"], solve3_s = drive_solve(
            torch, dh3, A3, b3, "3-D, b = A 1", kernels, limit=20)
        t1 = time.perf_counter()
        _, hist3 = dh3.solve_mixed(np.zeros(N3), b3, tol=1e-8, max_iter=100,
                                   return_device=True)
        torch.cuda.synchronize()
        warm3_s = time.perf_counter() - t1
        print(f"solve (3-D, warm): {len(hist3) - 1} refinements in "
              f"{warm3_s:.3f} s")
        b3r = A3.mult(np.random.default_rng(args.seed).standard_normal(N3))
        kernels.reset_launches()
        _, hist3r = dh3.solve_mixed(np.zeros(N3), b3r, tol=1e-8,
                                    max_iter=100, return_device=True)
        print(f"solve (3-D, random x_true): {len(hist3r) - 1} refinements "
              f"to {hist3r[-1]:.3e}")
        if hist3r[-1] > 1e-8:
            raise AssertionError(f"3-D random x_true: no 1e-8: {hist3r}")
        solve_launches3 = dict(kernels.LAUNCHES)   # the random x_true solve
        cyc3 = cycle_report(torch, dh3, b3, kernels)
        prof["3d"] = profile_levels(torch, dh3, f"3-D {n3}^3", cyc3)
        k, res = reference_check(torch, lap27_setup, 24, np.ones)
        print(f"reference: 24^3 float64 solve, card == CPU plain versions "
              f"({k} cycles to {res:.3e})")
        summary3.update(solve_refinements_ones=k3, solve_s_first=solve3_s,
                        solve_s_warm=warm3_s,
                        solve_refinements_random=len(hist3r) - 1,
                        solve_launches_random=solve_launches3, **cyc3)
        phase("3-D solve", t0)

    if 8 in run:
        # 8. transfer formats on level-0 P and P^T
        t0 = time.perf_counter()
        packed, by_path["transfer"] = transfer_formats(
            torch, ml3, dh3.lane_pad, kernels, args.seed)
        print(f"transfer path launches {by_path['transfer']}")
        summary3["transfer"] = time_transfer(torch, packed, gen)
        phase("transfer formats", t0)

    if 9 in run:
        # 9. the 3-D kernels against their plain versions: each format the
        # hierarchy picked (on its largest operator), and the forced
        # level-0 P and P^T
        t0 = time.perf_counter()
        cases = [("wind_ell_spmv", f"3-D {label}", M, host(), embed)
                 for label, M, host, embed in operators(dh3, ml3)
                 if M.on_format == "well"]
        for f in sorted({o[1].on_format for o in operators(dh3, ml3)}):
            if f in FORMAT_KERNEL and f != "well":
                label, M, host, embed = largest(dh3, ml3, f)
                cases.append((FORMAT_KERNEL[f], f"3-D {label}", M, host,
                              embed))
        # and the BDIA operator with the most bytes times launches per
        # cycle
        cases.append(("bdia_spmv", "3-D A1", dh3.levels[1].A,
                      ml3.levels[1].A, None))
        for label, f, M, host, embed, *_ in packed:
            if f in ("well", "wellt", "bell"):
                cases.append((FORMAT_KERNEL[f], f"3-D {label} forced {f}", M,
                              host, embed))
        run_checks(torch, cases, dh3.lane_pad, gen, checks)
        del cases
        phase("3-D kernels", t0)
    if 8 in run:
        del packed

    if 10 in run:
        # 10. the reference's SOR example and the Krylov solvers
        t0 = time.perf_counter()
        summaryk = S["2d_sor_krylov"] = sor_krylov(torch, args.nk, kernels,
                                                   by_path)
        phase("2-D SOR and Krylov", t0)

    if 11 in run:
        # 11. smoothed aggregation: the solve at both sides, then the
        # kernels on SA's own operators
        t0 = time.perf_counter()
        summary_sa = S["sa"] = {}
        cases = []
        for n_sa, key in zip(args.sa, ("3d_sa", "3d_sa64")):
            summary_sa[key], dhs, mls = smoothed_aggregation(
                torch, n_sa, kernels, by_path, key)
            per_cycle = summary_sa[key]["launches_per_vcycle"]
            ops = {label: (M, host, embed)
                   for label, M, host, embed in operators(dhs, mls)}
            for label in SA_CHECKS[key]:
                M, host, embed = ops[label]
                want = SA_FORMATS.get(n_sa, {}).get(label)
                if want is not None and M.on_format != want:
                    raise AssertionError(f"SA {n_sa}^3 {label} packed as "
                                         f"{M.on_format}, not {want}")
                name = FORMAT_KERNEL.get(M.on_format)
                if name is None:
                    continue
                if not per_cycle[name]:
                    raise AssertionError(f"SA {n_sa}^3: {name} ({label}) is "
                                         f"not in the V-cycle: {per_cycle}")
                cases.append((name, f"SA {n_sa}^3 {label}", M, host(),
                              embed))
            del dhs, mls, ops
        run_checks(torch, cases, 128, gen, checks)
        del cases
        phase("smoothed aggregation", t0)

    if 12 in run:
        # 12. blocked AMG: the solve and PCG at both sizes, then the block
        # SpMV and the kernels on the full size's own operators
        t0 = time.perf_counter()
        summary_bsr = S["bsr"] = blocked_amg_phase(
            torch, tuple(args.bsr), kernels, by_path, gen, checks)
        phase("blocked AMG", t0)

    if 13 in run:
        # 13. the setups on the card: the device engines beside the host
        # engines of phases 6, 3 and 11
        t0 = time.perf_counter()
        sa64 = summary_sa["3d_sa64"]
        host_setups = {
            "3d": {k: summary3[k] for k in (
                "size", "levels", "setup_s", "setup_phase_totals",
                "solve_refinements_ones")},
            "2d": {**summary2, "size": n},
            "sa": {"size": args.sa[1], "levels": len(sa64["levels"]),
                   "setup_s": sa64["setup_s"],
                   "setup_phase_totals": {
                       k: sum(d.get(k, 0.0) for d in sa64["setup_phases"])
                       for k in set().union(*sa64["setup_phases"])},
                   "solve_refinements_ones": sa64[
                       "solve_refinements_ones"]}}
        del dh3, ml3, A3
        torch.cuda.empty_cache()
        S["setup_on_card"] = setup_on_card(torch, n // 2, args.card_n3,
                                           args.sa[1], host_setups, kernels,
                                           by_path)
        phase("setup on the card", t0)
    elif 6 in run:
        del dh3, ml3, A3
        torch.cuda.empty_cache()

    if 14 in run:
        # 14. the topology-aware exchange and the distributed setup
        t0 = time.perf_counter()
        example = tap_example(torch, kernels, by_path)
        # at (n/4)^2, 512^2 by default ((n/2)^2 before phase 21, cut to
        # make room for it), which phases 15-17 take on
        dist, A14, ml14 = dist_flagship(torch, n // 4, kernels, by_path)
        prof["comm"] = comm_model(ml14, 4)
        summary_tap = S["tap"] = {
            "example": example, "distributed": dist,
            "card_cpu_rel_err": tap_reference_check(torch)}
        phase("TAP and the distributed setup", t0)

    if 15 in run:
        # 15. the SPMD bridge on 14b's problem, the distributed SA and
        # blocked setups, and the bridge's cycle on the card against the
        # CPU
        t0 = time.perf_counter()
        bridge, hier15 = spmd_bridge(torch, ml14, A14, dist, kernels,
                                     by_path)
        summary_spmd = S["spmd"] = {"bridge": bridge}
        del ml14, A14
        torch.cuda.empty_cache()
        summary_spmd["sa"] = spmd_sa(torch, kernels, by_path)
        summary_spmd["bsr"] = spmd_blocked(torch, kernels, by_path)
        summary_spmd["card_cpu_rel_err"] = spmd_reference_check(torch)
        summary_spmd["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase15": summary_spmd}))
        phase("distributed SA and blocked setups, the SPMD bridge", t0)
    elif 14 in run:
        del ml14, A14

    if 16 in run:
        # 16. the setup over real processes and one controller per shard
        t0 = time.perf_counter()
        summary_mc = S["mc"] = multi_controller(torch, hier15, bridge,
                                                kernels, by_path)
        summary_mc["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase16": summary_mc}))
        phase("the setup over processes, one controller per shard", t0)

    if 17 in run:
        # 17. TAP and the Krylov solvers across controllers
        t0 = time.perf_counter()
        summary_mct = S["mc_tap"] = mc_tap_krylov(torch, hier15, bridge,
                                                  summary_mc, kernels,
                                                  by_path)
        summary_mct["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase17": summary_mct}))
        phase("TAP and Krylov across controllers", t0)
    if 15 in run:
        del hier15

    if 18 in run:
        # 18. systems AMG, RAP sparsification and the profiling layer
        t0 = time.perf_counter()
        summary_18 = S["phase18"] = {
            **systems_and_sparsify(torch, args.bsr, n // 2,
                                   summary_bsr["2d_bsr"], by_path),
            "profiling": {**prof, **summaryk["profile"]}}
        summary_18["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase18": summary_18}))
        phase("systems AMG, RAP sparsification, profiling", t0)

    if 19 in run:
        # 19. the real-matrix path: a matrix file, k-way repartition,
        # topology placement, diagonal scaling, a checkpointed setup and
        # AMG-PCG
        t0 = time.perf_counter()
        S["dg_512"] = real_matrix(torch, kernels, by_path, gen, checks)
        phase("the real-matrix path", t0)

    if 20 in run:
        # 20. the containers and the rest of the host library
        t0 = time.perf_counter()
        summary_20 = S["phase20"] = containers(torch, kernels, by_path,
                                               args.seed)
        summary_20["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase20": summary_20}))
        phase("the containers and the host library", t0)

    if 21 in run:
        # 21. the twins of the JAX package's example scripts
        t0 = time.perf_counter()
        summary_21 = S["phase21"] = {"twins": examples_phase(
            torch, kernels, by_path)}
        summary_21.update(twin_figures(summary_21["twins"]))
        summary_21["overlap_trace"] = overlap_trace(torch)
        summary_21["seconds"] = time.perf_counter() - t0
        print(json.dumps({"phase21": summary_21}))
        phase("the twins of the example scripts", t0)

    S.update(copy_gbs=copy_gbs, run_s=time.perf_counter() - t_start)
    print(json.dumps(S))
    print(json.dumps({"kernels": kernel_rows(
        kernels, checks, by_path, S, full=run == set(select_phases()))}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def per_vcycle(S):
    """Each cycle's launches per kernel, by path, from the summaries of the
    phases that ran: {path: {kernel: launches}}."""
    where = {
        "2d": ("2d",), "3d": ("3d",),
        "2d_sor": ("2d_sor_krylov", "launches_per_sor_vcycle"),
        "3d_sa": ("sa", "3d_sa"), "3d_sa64": ("sa", "3d_sa64"),
        "2d_bsr": ("bsr", "2d_bsr"), "2d_bsr128": ("bsr", "2d_bsr128"),
        "2d_tap": ("tap", "example", "cycles", "tap0"),
        "2d_dist_tap": ("tap", "distributed", "tap0"),
        "2d_spmd": ("spmd", "bridge", "plain"),
        "2d_spmd_tap": ("spmd", "bridge", "tap0"),
        "3d_sa_spmd": ("spmd", "sa"), "2d_bsr_dist": ("spmd", "bsr"),
        "2d_mc": ("mc",), "2d_mc_tap": ("mc_tap",),
        "2d_systems": ("phase18", "systems"),
        "2d_sparsified": ("phase18", "sparsify", "sparsified"),
        "2d_unsparsified": ("phase18", "sparsify", "plain"),
        "dg_512_pcg_iteration": ("dg_512",),
        "2d_containers": ("phase20", "flagship")}
    out = {}
    for path, keys in where.items():
        d = S
        for k in keys:
            d = d.get(k) if isinstance(d, dict) else None
        if isinstance(d, dict):
            key = ("launches_per_pcg_iteration" if path.startswith("dg_")
                   else "launches_per_vcycle")
            if path == "2d_sor":
                out[path] = d
            elif key in d:
                out[path] = d[key]
    return out


def kernel_rows(kernels, checks, by_path, S, full=True):
    """The kernel list: for each kernel its launches over every path that
    ran, and the float32 check on the main path's operator (the forced
    transfer operator for a kernel the automatic picks leave out) with its
    float64 twin. After a selection of phases (``full`` False) a check's
    numbers are null when no phase that ran checked the kernel; after
    every phase a kernel without both checks is a failure."""
    cycles = per_vcycle(S)
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "operator")
    out = []
    for name in kernels.LAUNCHES:
        cs = checks.get(name, [])
        c = next((c for c in cs if c["dtype"] == "float32"), {})
        c64 = next((c for c in cs if c["dtype"] == "float64"), {})
        if full and not (c and c64):
            raise AssertionError(f"{name}: no float32 and float64 check "
                                 f"after every phase")
        out.append({
            "name": name, "route": "cuda",
            "source": f"raptor_tpu_torch/csrc/{name}.cu",
            "replaces": f"raptor_tpu/device/pallas_kernels.py:"
                        f"{REPLACES[name]}",
            "launches": sum(p[name] for p in by_path.values()),
            **{k: c.get(k) for k in keys},
            "launches_by_path": {p: v[name] for p, v in by_path.items()},
            "launches_per_vcycle": {p: v[name] for p, v in cycles.items()},
            "float64": {k: c64.get(k) for k in (
                "operator", "max_abs_err", "rel_err", "ms", "plain_ms",
                "library_ms", "bound_ms")},
            "checks": [{k: c[k] for k in ("operator", "dtype", "rel_err",
                                           "ms", "call_ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "packed_read_ms", "tiles",
                                           "tile_share", "tile_fill",
                                           "tile_bound_ms",
                                           "all_planes_bound_ms",
                                           "padded_bound_ms", "real_slots",
                                           "warps", "real_entries", "nnz",
                                           "slots", "fill", "col_bytes")
                        if k in c}
                       for c in cs]})
    return out


if __name__ == "__main__":
    sys.exit(main())
