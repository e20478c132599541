#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raptor_tpu_torch) through its main path
on one NVIDIA card, and check what comes out.

    python3 chip_smoke.py [--n 2048] [--seed 0]

Phases, each printed as it ends; any failure ends the run with a non-zero
exit code and no result line:

1. card: its name and power limit;
2. build: the host setup library (csrc/setup_kernels.cpp) and the CUDA
   kernels (raptor_tpu_torch/csrc/*.cu), all compilers started together;
3. setup: n x n rotated anisotropic diffusion, Ruge-Stuben + modified
   classical interpolation, theta 0.25, Chebyshev(3), on the host; then the
   float32 device hierarchy, with each operator's format;
4. kernels: each CUDA kernel against its plain PyTorch version on the real
   packed operators, in float32 and float64, and their times beside the
   byte bound and a torch.sparse CSR product of the same operator;
5. solve: mixed-precision refinement to 1e-8 relative residual, with the
   kernel launch counts of that run, the residual recomputed on the host,
   per-level V-cycle times, and a small problem solved on the card and with
   the plain versions on the CPU, which must agree.

The last two lines are the card's ``name, power.limit`` and then
``{"ok": true, "device": {...}}``; the line before them lists the kernels.
Needs one card; exits non-zero without CUDA or without the package.
"""

import argparse
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
TOL = {"float32": 1e-5, "float64": 1e-12}


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


def largest_bdia(dh, ml):
    """(label, packed f32 operator, host matrix, embed) of the BDIA
    operator of the hierarchy with the most plane slots."""
    ops = []
    for i, (dl, hl) in enumerate(zip(dh.levels, ml.levels)):
        ops.append((f"A{i}", dl.A, lambda hl=hl: hl.A, None))
        if dl.P is not None:
            ops.append((f"P{i}", dl.P, lambda hl=hl: hl.P, "cols"))
            ops.append((f"Pt{i}", dl.Pt, lambda hl=hl: hl.P.transpose(),
                        "rows"))
    bdia = [o for o in ops if o[1].on_format == "bdia"]
    if not bdia:
        raise AssertionError("no BDIA operator in the hierarchy")
    label, M, host, embed = max(bdia, key=lambda o: o[1].bd_vals.numel())
    return label, M, host(), embed


def kernel_input_len(M):
    """Length of the x the on-block kernel reads (the embedded space for
    an operator embedded by columns)."""
    return M.rows_pad if M.embed_kind == "cols" else M.cols_pad


def check_kernel(torch, name, M, host, gen):
    """One kernel on one packed operator: error against the plain version,
    kernel / plain / torch.sparse times, byte bound."""
    from raptor_tpu_torch.device import formats, kernels
    dt = str(M.dtype).replace("torch.", "")
    S = M.n_shards
    x = torch.randn((S, kernel_input_len(M)), generator=gen,
                    device="cuda").to(M.dtype)
    isz = M.dia_vals.element_size()
    if name == "dia_spmv":
        def kern():
            return kernels.dia_spmv(M.dia_offsets, M.dia_off, M.dia_vals, x,
                                    M.dia_pad)

        def plain():
            return formats.dia_spmv(M.dia_offsets, M.dia_vals, x, M.dia_pad)
        K, R = M.dia_vals.shape[1:]
        nbytes = S * ((K * R + x.shape[1] + R) * isz + 4 * K)
        flops = 2 * S * K * R
    else:
        def kern():
            return kernels.bdia_spmv(M.bd_offsets, M.bd_off, M.bd_idx,
                                     M.bd_vals, x, M.bd_padb, M.on_rows_pad)

        def plain():
            return formats.bdia_spmv(M.bd_offsets, M.bd_idx, M.bd_vals, x,
                                     M.bd_padb, M.on_rows_pad)
        slots = M.bd_vals.numel()
        nbytes = (slots * (isz + 1) + S * (x.shape[1] + M.on_rows_pad) * isz
                  + 4 * len(M.bd_offsets))
        flops = 2 * slots
    got, ref = kern(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.isfinite(got).all() or err > TOL[dt] * scale:
        raise AssertionError(f"{name} {dt}: max abs err {err} against max "
                             f"abs {scale} (limit {TOL[dt]} relative)")
    # the library yardstick: one torch.sparse CSR product of the same
    # operator (timed here only; the port never calls it)
    g = host.global_csr
    sp = torch.sparse_csr_tensor(
        torch.from_numpy(g.indptr).cuda(), torch.from_numpy(g.indices).cuda(),
        torch.from_numpy(g.data).cuda().to(M.dtype), size=g.shape)
    xs = torch.randn(g.n_cols, generator=gen, device="cuda").to(M.dtype)
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {
        "dtype": dt, "max_abs_err": err, "rel_err": err / max(scale, 1e-300),
        "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
        "library_ms": time_ms(torch, lambda: sp @ xs),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "bytes": int(nbytes)}


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


def reference_check(torch, n=64):
    """A small problem solved on the card and with the plain versions on
    the CPU (float64): the residual histories must agree."""
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    A, ml = aniso_setup(n)
    b = A.mult(np.random.default_rng(1).standard_normal(n * n))
    out = {}
    for dev in ("cuda", "cpu"):
        dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=128,
                             device=dev)
        dh.solve_tol = 1e-9
        out[dev] = dh.solve(dh.vector(np.zeros(n * n)), dh.vector(b))
    g, c = out["cuda"], out["cpu"]
    k = c.n_iters
    if g.n_iters != k or not np.allclose(g.res[:k + 1], c.res[:k + 1],
                                         rtol=1e-9, atol=1e-16):
        raise AssertionError(f"card and CPU disagree at {n}^2: "
                             f"{g.res[:k + 1]} vs {c.res[:k + 1]}")
    return k, float(c.res[k])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048, help="grid side")
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
        from raptor_tpu_torch.device.par import device_put_matrix
        from raptor_tpu_torch.multilevel.device_hierarchy import (
            DeviceHierarchy)
    except ImportError as e:
        print(f"chip_smoke: the raptor_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = args.n

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

    # 3. setup (host), then the device hierarchy
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
    for i, lvl in enumerate(dh.levels):
        fmts = [lvl.A.on_format] + ([] if lvl.P is None else [
            f"{lvl.P.on_format}/{lvl.P.embed_kind}",
            f"{lvl.Pt.on_format}/{lvl.Pt.embed_kind}"])
        print(f"  level {i:2d}: A {fmts[0]:4s}" + (
            f"  P {fmts[1]:10s}  Pt {fmts[2]}" if lvl.P is not None else ""))
    phase("setup", t0)

    # 4. kernels against their plain versions on the real operators
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    # float32: the main path's own operators; float64: the same host
    # matrices packed in float64
    cases = {"dia_spmv": ("A0", dh.levels[0].A, ml.levels[0].A, None),
             "bdia_spmv": largest_bdia(dh, ml)}
    checks = {}
    for name, (label, M32, host, embed) in cases.items():
        checks[name] = []
        for dtype in (torch.float32, torch.float64):
            M = M32 if dtype == torch.float32 else device_put_matrix(
                host, dtype=dtype, lane_pad=dh.lane_pad, embed=embed,
                need_transpose=False)
            want = "dia" if name == "dia_spmv" else "bdia"
            if M.on_format != want:
                raise AssertionError(f"{label} packed as {M.on_format}")
            c = check_kernel(torch, name, M, host, gen)
            c["operator"] = label
            checks[name].append(c)
            print(f"  {name} on {label} ({c['dtype']}): rel err "
                  f"{c['rel_err']:.3e}, kernel {c['ms']:.4f} ms, plain "
                  f"{c['plain_ms']:.4f} ms, torch.sparse "
                  f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bytes']} B)")
    phase("kernels", t0)

    # 5. the main path: mixed-precision solve to 1e-8
    t0 = time.perf_counter()
    x_true = np.random.default_rng(args.seed).standard_normal(n * n)
    b = A.mult(x_true)
    kernels.reset_launches()
    x, hist = dh.solve_mixed(np.zeros(n * n), b, tol=1e-8, max_iter=100)
    launches = dict(kernels.LAUNCHES)
    solve_s = time.perf_counter() - t0
    relres = float(np.linalg.norm(b - A.mult(x)) / np.linalg.norm(b))
    print(f"solve: {len(hist) - 1} refinements to {hist[-1]:.3e} "
          f"(host-recomputed {relres:.3e}) in {solve_s:.3f} s, first call; "
          f"launches {launches}")
    if not (np.isfinite(x).all() and x.shape == (n * n,)):
        raise AssertionError("solution is not finite or has the wrong shape")
    if hist[-1] > 1e-8 or relres > 1e-8 or len(hist) - 1 > 20:
        raise AssertionError(f"no 1e-8 within 20 refinements: {hist}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel did not run in the solve: {launches}")
    t1 = time.perf_counter()
    _, hist2 = dh.solve_mixed(np.zeros(n * n), b, tol=1e-8, max_iter=100,
                              return_device=True)
    print(f"solve (warm): {len(hist2) - 1} refinements in "
          f"{time.perf_counter() - t1:.3f} s")
    # the right-hand side of the JAX package's record (b = A 1: 15
    # refinements at 2048^2, BASELINE_RESULTS.md)
    b1 = A.mult(np.ones(n * n))
    _, hist1 = dh.solve_mixed(np.zeros(n * n), b1, tol=1e-8, max_iter=100,
                              return_device=True)
    print(f"solve (b = A 1): {len(hist1) - 1} refinements to "
          f"{hist1[-1]:.3e}")
    if hist1[-1] > 1e-8 or len(hist1) - 1 > 20:
        raise AssertionError(f"b = A 1: no 1e-8 within 20: {hist1}")

    xd = dh.vector(np.zeros(n * n))
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
    print(f"  sum of levels {sum(lv):.3f} ms")
    k, res = reference_check(torch)
    print(f"reference: 64^2 float64 solve, card == CPU plain versions "
          f"({k} cycles to {res:.3e})")
    phase("solve", t0)

    out = []
    sources = {"dia_spmv": 47, "bdia_spmv": 112}
    for name, cs in checks.items():
        c = cs[0]   # float32: the dtype of the hierarchy the solve runs
        out.append({
            "name": name, "route": "cuda",
            "source": f"raptor_tpu_torch/csrc/{name}.cu",
            "replaces": f"raptor_tpu/device/pallas_kernels.py:"
                        f"{sources[name]}",
            "launches": launches[name], "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "operator": c["operator"], "launches_per_vcycle":
                per_cycle[name],
            "float64": {k: cs[1][k] for k in ("max_abs_err", "rel_err",
                                              "ms", "plain_ms",
                                              "library_ms", "bound_ms")}})
    print(json.dumps({"n": n, "levels": ml.num_levels, "setup_s": setup_s,
                      "solve_refinements": len(hist) - 1,
                      "solve_refinements_ones": len(hist1) - 1,
                      "relres": float(hist[-1]), "vcycle_ms": cycle_ms,
                      "vcycle_enqueue_ms": enqueue_ms,
                      "vcycle_kernels": n_kern, "vcycle_busy_ms": busy_ms,
                      "level_ms": lv,
                      "copy_gbs": copy_gbs}))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
