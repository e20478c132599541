#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raptor_tpu_torch) through its main path
on one NVIDIA card, and check what comes out.

    python3 chip_smoke.py [--n 2048] [--n3 128] [--seed 0]

Phases, each printed as it ends; any failure ends the run with a non-zero
exit code and no result line:

1. card: its name and power limit;
2. build: the host setup library (csrc/setup_kernels.cpp) and the CUDA
   kernels (raptor_tpu_torch/csrc/*.cu), all compilers started together;
3. setup: n x n rotated anisotropic diffusion, Ruge-Stuben + modified
   classical interpolation, theta 0.25, Chebyshev(3), on the host; then the
   float32 device hierarchy, with each operator's format (all DIA/BDIA);
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
   bound and torch.sparse;
9. 3-D kernels: every kernel of a format the 3-D hierarchy picked (BDIA
   on its largest operator and on A1), and the windowed-ELL,
   sorted-scatter and BELL kernels on the forced level-0 P and P^T,
   against their plain versions in float32 and float64.

The last two lines are the card's ``name, power.limit`` and then
``{"ok": true, "device": {...}}``; the line before them lists the kernels.
Needs one card; exits non-zero without CUDA or without the package.
"""

import argparse
import functools
import json
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
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s", flush=True)


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


def aniso_setup(n):
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


def needed_bytes(M):
    """Bytes of the packed arrays one on-block apply of ``M`` must read:
    the layout's bytes (``par.packed_bytes``, the format rule's count),
    but for BELL only the real slots (``bl_cnt``: values, lane ids, source
    block ids) and the counts, and for the sorted scatter only the real
    entries (``wl_cnt``: values, metadata), the slot window bases and the
    counts; the two kernels read nothing past a count."""
    from raptor_tpu_torch.device.par import packed_bytes
    isz = M.on_vals.element_size()
    if M.on_format == "bell":
        return (int(M.bl_cnt.sum()) * (128 * (1 + isz) + 4)
                + 4 * M.bl_cnt.numel())
    if M.on_format == "wellt":
        return (int(M.wl_cnt.sum()) * (4 + isz)
                + 4 * (M.wl_ws.numel() + M.wl_cnt.numel()))
    return packed_bytes(M)


def padded_bytes(M):
    """What a BELL or sorted-scatter kernel that walks the padded layout
    reads: every BELL slot; every sorted-scatter value, the metadata of the
    nonzero ones and the window bases."""
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
    a multiply-add per stored slot (per slot of a listed tile for BDIA,
    which reads no other tile; per lane of a real BELL slot; per entry with
    a value for the sorted-scatter kernel, which reads no entry past a
    slot's count)."""
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
        # the kernel reads the listed tiles of the row blocks below
        # on_rows_pad, the list itself and one offset per plane
        args = (M.bd_offsets, M.bd_idx, M.bd_vals, x, M.bd_padb,
                M.on_rows_pad)
        kern = ((M.bd_offsets, M.bd_off) + args[1:]
                + (M.bd_tptr, M.bd_tplane))
        tiles = int(M.bd_tptr[:, -1].sum())
        nbytes = (tiles * 128 * (isz + 1) + 4 * (M.bd_tptr.numel() + tiles)
                  + S * (C + M.on_rows_pad) * isz + 4 * len(M.bd_offsets))
        ops = 2 * tiles * 128
    elif name == "wind_ell_spmv":
        args = kern = (M.wl_ws, M.on_cols, M.on_vals, x, M.wl_ba, M.wl_wr,
                       M.rows_pad)
        nbytes = needed_bytes(M) + S * (C + M.rows_pad) * isz
        ops = 2 * S * M.on_vals.shape[1] * M.rows_pad
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
    from raptor_tpu_torch.device.par import bdia_tile_share
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
    if name == "bdia_spmv":
        # and the bound of a kernel that streams every plane of the row
        # blocks below on_rows_pad (the one-thread-per-row BDIA kernel)
        S, P = M.bd_vals.shape[:2]
        isz = M.bd_vals.element_size()
        dense = (S * P * M.on_rows_pad * (isz + 1) + 4 * P
                 + S * (x.shape[1] + M.on_rows_pad) * isz)
        tiles = int(M.bd_tptr[:, -1].sum())
        c.update(tiles=tiles, tile_share=bdia_tile_share(M),
                 tile_fill=int((M.bd_vals != 0).sum()) / max(1, 128 * tiles),
                 all_planes_bytes=dense,
                 all_planes_bound_ms=bound(dense, 2 * S * P * M.on_rows_pad,
                                           dt)[0])
    if name in ("bell_spmv", "swellt_spmv_T"):
        # and the bound of a kernel that walks the padded layout
        n_out = M.on_rows_pad if name == "bell_spmv" else M.rows_pad
        isz = M.on_vals.element_size()
        padded = padded_bytes(M) + M.n_shards * (x.shape[1] + n_out) * isz
        c.update(padded_bytes=padded,
                 padded_bound_ms=bound(padded, ops, dt)[0])
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
        return (f", {c['tiles']} tiles = {c['tile_share']:.1%}, "
                f"{c['tile_fill']:.1%} of their slots filled; every plane "
                f"{c['all_planes_bytes']} B, bound "
                f"{c['all_planes_bound_ms']:.4f} ms")
    if "real_slots" in c:
        return (f", {c['real_slots']} of {c['slots']} slots real in "
                f"{c['live_blocks']} row blocks, {c['warps']} warps; padded "
                f"layout {c['padded_bytes']} B, bound "
                f"{c['padded_bound_ms']:.4f} ms")
    if "modelled_global_atomics" in c:
        return (f", {c['real_entries']} real entries, {c['nnz']} nonzeros, "
                f"{c['modelled_global_atomics']} global atomics by the host "
                f"model of {c['group']} tiles a CTA and a {c['span']}-block "
                f"window; padded layout {c['padded_bytes']} B, bound "
                f"{c['padded_bound_ms']:.4f} ms")
    return ""


def run_checks(torch, cases, lane_pad, gen, checks):
    """``cases``: (kernel, label, float32 operator, host, embed); each is
    checked as it is and repacked in float64 in the same format."""
    from raptor_tpu_torch.device.par import device_put_matrix
    for name, label, M32, host, embed in cases:
        for dtype in (torch.float32, torch.float64):
            M = M32
            if dtype == torch.float64:
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
                    and torch.equal(M.wl_cnt, M32.wl_cnt)):
                raise AssertionError(f"{label}: the {dtype} pack lists "
                                     f"other tiles, slots or entries than "
                                     f"the float32 one")
            c = check_kernel(torch, name, M, host, gen)
            c["operator"] = label
            checks.setdefault(name, []).append(c)
            print(f"  {name} on {label} ({c['dtype']}): rel err "
                  f"{c['rel_err']:.3e}, kernel {c['ms']:.4f} ms (call by "
                  f"call {c['call_ms']:.4f} ms), plain "
                  f"{c['plain_ms']:.4f} ms, torch.sparse "
                  f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bytes']} B{detail(c)})", flush=True)
            del M


def level_times(torch, dh, reps=20):
    """Device time of each level's share of one V-cycle: smoothing,
    residual, restriction and prolongation (the coarse solve on the
    coarsest level), by CUDA events."""
    from raptor_tpu_torch.device.par import spmv
    from raptor_tpu_torch.device.relax import chebyshev
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
            x = chebyshev(lvl.A, lvl.RX, torch.zeros_like(b), b,
                          dh.num_smooth_sweeps)
            spmv(lvl.Pt, b - spmv(lvl.A, x))
            x = x + spmv(lvl.P, xc)
            return chebyshev(lvl.A, lvl.RX, x, b, dh.num_smooth_sweeps)
        rows.append(time_ms(torch, share, reps))
    return rows


def device_busy(torch, fn):
    """(kernel count, summed kernel ms) of one call, from torch.profiler's
    device trace; (0, 0.0) when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3


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


def lap27_setup(n):
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
    ml.setup(A)
    return A, ml


def path_kernels(dh):
    """The kernels the solve of this hierarchy launches: one per format of
    its operators, and DIA for the float64 residual of the stencil A."""
    fmts = {"dia"}
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
    idle = [name for name in path_kernels(dh) if launches[name] == 0]
    if idle:
        raise AssertionError(f"{what}: kernels of the path did not run: "
                             f"{idle} ({launches})")
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
            packed.append((label, f or "auto", M, host, embed, x, err,
                           pack_s))
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
    for label, f, M, host, _, x, err, pack_s in packed:
        isz = M.on_vals.element_size()
        nbytes = (needed_bytes(M)
                  + M.n_shards * (x.shape[1] + M.rows_pad) * isz)
        ms = kernel_ms(torch, lambda M=M, x=x: spmv(M, x))
        lib = torch_sparse(torch, host, M.dtype, gen)
        bound_ms, _ = bound(nbytes, 0, "float32")
        rows.append({"operator": label, "forced": f, "format": M.on_format,
                     "embed": M.embed_kind, "ms": ms, "bound_ms": bound_ms,
                     "library_ms": lib, "bytes": int(nbytes),
                     "rel_err": err, "pack_s": pack_s})
        print(f"  {label} {f:5s} -> {M.on_format:5s}/{M.embed_kind:4s}: "
              f"spmv {ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B), "
              f"torch.sparse {lib:.4f} ms, rel err {err:.2e}, packed in "
              f"{pack_s:.2f} s", flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048, help="2-D grid side")
    ap.add_argument("--n3", type=int, default=128, help="3-D grid side")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

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

    # 3. 2-D setup (host), then the device hierarchy
    t0 = time.perf_counter()
    A, ml = aniso_setup(n)
    setup_s = time.perf_counter() - t0
    print(ml.print_hierarchy())
    if n == 2048 and ml.num_levels != 14:
        raise AssertionError(f"{ml.num_levels} levels at 2048^2, want 14")
    print(f"setup: {ml.num_levels} levels in {setup_s:.3f} s")
    t1 = time.perf_counter()
    dh = DeviceHierarchy(ml, dtype=torch.float32)
    torch.cuda.synchronize()
    print(f"device hierarchy (float32, lane_pad {dh.lane_pad}): "
          f"{time.perf_counter() - t1:.3f} s")
    print("\n".join(dh.format_summary()))
    # the 2-D operators keep the structural picks: DIA or BDIA throughout
    off = [o[0] for o in operators(dh, ml)
           if o[1].on_format not in ("dia", "bdia")]
    if off:
        raise AssertionError(f"2-D operators off DIA/BDIA: {off}")
    phase("setup", t0)

    # 4. kernels against their plain versions on the real operators
    # (float32: the main path's own operators; float64: the same host
    # matrices packed in float64)
    t0 = time.perf_counter()
    label, M, host, embed = largest(dh, ml, "bdia")
    run_checks(torch, [("dia_spmv", "A0", dh.levels[0].A, ml.levels[0].A,
                        None),
                       ("bdia_spmv", label, M, host, embed)],
               dh.lane_pad, gen, checks)
    del M, host
    phase("kernels", t0)

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
    _, hist1 = dh.solve_mixed(np.zeros(n * n), b1, tol=1e-8, max_iter=100,
                              return_device=True)
    print(f"solve (b = A 1): {len(hist1) - 1} refinements to "
          f"{hist1[-1]:.3e}")
    if hist1[-1] > 1e-8 or len(hist1) - 1 > 20:
        raise AssertionError(f"b = A 1: no 1e-8 within 20: {hist1}")
    cyc2 = cycle_report(torch, dh, b, kernels)
    k, res = reference_check(torch, aniso_setup, 64,
                             lambda m: np.random.default_rng(1)
                             .standard_normal(m))
    print(f"reference: 64^2 float64 solve, card == CPU plain versions "
          f"({k} cycles to {res:.3e})")
    summary2 = {"n": n, "levels": ml.num_levels, "setup_s": setup_s,
                "solve_refinements": k2,
                "solve_refinements_ones": len(hist1) - 1, **cyc2}
    del dh, ml, A, b, b1
    torch.cuda.empty_cache()
    phase("solve", t0)

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
    phase("3-D setup", t0)

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
    _, hist3r = dh3.solve_mixed(np.zeros(N3), b3r, tol=1e-8, max_iter=100,
                                return_device=True)
    print(f"solve (3-D, random x_true): {len(hist3r) - 1} refinements to "
          f"{hist3r[-1]:.3e}")
    if hist3r[-1] > 1e-8:
        raise AssertionError(f"3-D random x_true: no 1e-8: {hist3r}")
    solve_launches3 = dict(kernels.LAUNCHES)   # the random x_true solve
    cyc3 = cycle_report(torch, dh3, b3, kernels)
    k, res = reference_check(torch, lap27_setup, 24, np.ones)
    print(f"reference: 24^3 float64 solve, card == CPU plain versions "
          f"({k} cycles to {res:.3e})")
    phase("3-D solve", t0)

    # 8. transfer formats on level-0 P and P^T
    t0 = time.perf_counter()
    packed, by_path["transfer"] = transfer_formats(torch, ml3, dh3.lane_pad,
                                                   kernels, args.seed)
    print(f"transfer path launches {by_path['transfer']}")
    transfer = time_transfer(torch, packed, gen)
    phase("transfer formats", t0)

    # 9. the 3-D kernels against their plain versions: each format the
    # hierarchy picked (on its largest operator), and the forced level-0
    # P and P^T
    t0 = time.perf_counter()
    cases = []
    for f in sorted({o[1].on_format for o in operators(dh3, ml3)}):
        if f in FORMAT_KERNEL:
            label, M, host, embed = largest(dh3, ml3, f)
            cases.append((FORMAT_KERNEL[f], f"3-D {label}", M, host, embed))
    # and the BDIA operator with the most bytes times launches per cycle
    cases.append(("bdia_spmv", "3-D A1", dh3.levels[1].A, ml3.levels[1].A,
                  None))
    for label, f, M, host, embed, *_ in packed:
        if f in ("well", "wellt", "bell"):
            cases.append((FORMAT_KERNEL[f], f"3-D {label} forced {f}", M,
                          host, embed))
    run_checks(torch, cases, dh3.lane_pad, gen, checks)
    del cases, packed
    phase("3-D kernels", t0)

    out = []
    totals = {name: sum(p[name] for p in by_path.values())
              for name in kernels.LAUNCHES}
    for name in kernels.LAUNCHES:
        cs = checks[name]
        # the float32 check on the main path's operator (the forced
        # transfer operator for a kernel the automatic picks leave out)
        c = next(c for c in cs if c["dtype"] == "float32")
        c64 = next(c for c in cs if c["dtype"] == "float64")
        out.append({
            "name": name, "route": "cuda",
            "source": f"raptor_tpu_torch/csrc/{name}.cu",
            "replaces": f"raptor_tpu/device/pallas_kernels.py:"
                        f"{REPLACES[name]}",
            "launches": totals[name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "operator": c["operator"],
            "launches_by_path": {p: v[name] for p, v in by_path.items()},
            "launches_per_vcycle": {
                "2d": summary2["launches_per_vcycle"][name],
                "3d": cyc3["launches_per_vcycle"][name]},
            "float64": {k: c64[k] for k in ("operator", "max_abs_err",
                                            "rel_err", "ms", "plain_ms",
                                            "library_ms", "bound_ms")},
            "checks": [{k: c[k] for k in ("operator", "dtype", "rel_err",
                                           "ms", "call_ms", "plain_ms",
                                           "library_ms",
                                           "bound_ms", "tiles", "tile_share",
                                           "tile_fill", "all_planes_bound_ms",
                                           "padded_bound_ms", "real_slots",
                                           "warps", "real_entries", "nnz")
                          if k in c}
                       for c in cs]})
    summary3 = {"n3": n3, "levels": ml3.num_levels, "setup_s": setup3_s,
                "pack_s": pack3_s, "formats": formats3,
                "solve_refinements_ones": k3, "solve_s_first": solve3_s,
                "solve_s_warm": warm3_s,
                "solve_refinements_random": len(hist3r) - 1,
                "solve_launches_random": solve_launches3, **cyc3,
                "transfer": transfer}
    print(json.dumps({"2d": summary2, "3d": summary3, "copy_gbs": copy_gbs,
                      "run_s": time.perf_counter() - t_start}))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
