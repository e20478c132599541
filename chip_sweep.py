#!/usr/bin/env python3
"""Sweep the launch shapes of the port's BELL and sorted-scatter kernels on
the level-0 P and P^T of the 3-D 27-point Laplacian, on one NVIDIA card.

    python3 chip_sweep.py [--n3 128] [--seed 0]

Packs P0 (embedded by columns) and P^T0 (by rows) in the forced BELL
layout and P^T0 in the forced sorted-scatter layout, in float32 and
float64. The BELL kernel takes its warps per row block as an argument
(the wrapper derives them from the layout, ``kernels.bell_warps``), so
each warp count it is built for is launched from the kernel library. The
sorted-scatter kernel's group and window are constants of its source: each
shape is a variant of ``csrc/swellt_spmv_T.cu`` built with
``-DSWELLT_GROUP`` / ``-DSWELLT_SPAN`` (all ``nvcc`` at once) into the
git-ignored build directory. Every shape is checked against the plain
version, then timed back to back (``chip_smoke.kernel_ms``); a
sorted-scatter shape also gets its global atomics by the host model
(``kernels.swellt_modelled_global_atomics``). torch.sparse's CSR product
of the same operator is timed beside them. Prints one JSON line per
measurement; ``"chosen"`` marks the shape the wrapper launches. Needs one
card.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import chip_smoke

BELL_WARPS = (4, 8, 16)
SWELLT_GROUPS = (2, 4, 8, 16, 32, 64)
SWELLT_SPANS = (32, 64)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry points' arguments, as in csrc/bell_spmv.cu and
# csrc/swellt_spmv_T.cu (device/kernels.py binds the same)
BELL_ARGS = [_P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _I, _P]
SWELLT_ARGS = [_P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _P]


def build_swellt_variants(kernels):
    """{(group, span): library} of the sorted-scatter source built at each
    swept shape, one ``nvcc`` per shape, all started together."""
    out_dir = kernels.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for g in SWELLT_GROUPS:
        for sp in SWELLT_SPANS:
            so = out_dir / f"libswellt_spmv_T_g{g}_s{sp}.so"
            jobs[(g, sp)] = (so, subprocess.Popen(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, f"-DSWELLT_GROUP={g}",
                 f"-DSWELLT_SPAN={sp}", "-o", str(so),
                 str(kernels.SOURCES["swellt_spmv_T"])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for shape, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {shape} failed:\n{log}")
        libs[shape] = ctypes.CDLL(str(so))
    return libs


def entry(lib, name, dt, argtypes):
    fn = getattr(lib, f"{name}_{'f32' if dt == 'float32' else 'f64'}")
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def shape_of(lib, Kp):
    fn = lib.swellt_spmv_T_shape
    fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)], None
    group, span = _I(), _I()
    fn(Kp, ctypes.byref(group), ctypes.byref(span))
    return group.value, span.value


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n3", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device", file=sys.stderr)
        return 1
    from raptor_tpu_torch.device import formats, kernels
    from raptor_tpu_torch.device.par import device_put_matrix
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    kernels.build()
    bell_lib = ctypes.CDLL(str(kernels.BUILD_DIR / "libbell_spmv.so"))
    swellt_libs = build_swellt_variants(kernels)
    _, ml = chip_smoke.lap27_setup(args.n3)
    P = ml.levels[0].P
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    cases = (("P0", P, "cols", "bell"), ("Pt0", P.transpose(), "rows", "bell"),
             ("Pt0", P.transpose(), "rows", "wellt"))
    for label, host, embed, fmt in cases:
        for dtype in (torch.float32, torch.float64):
            dt = str(dtype).replace("torch.", "")
            M = device_put_matrix(host, dtype=dtype, lane_pad=128,
                                  embed=embed, force_format=fmt,
                                  need_transpose=False)
            S = M.n_shards
            x = torch.randn((S, chip_smoke.kernel_input_len(M)),
                            generator=gen, device="cuda").to(dtype)
            name = chip_smoke.FORMAT_KERNEL[fmt]
            _, plain, nbytes, ops = chip_smoke.kernel_spec(name, M, x)
            ref = plain()
            scale = float(ref.abs().max())
            row = {"operator": label, "format": fmt, "dtype": dt,
                   "bound_ms": chip_smoke.bound(nbytes, ops, dt)[0],
                   "library_ms": chip_smoke.torch_sparse(torch, host, dtype,
                                                         gen)}
            if fmt == "bell":
                out = torch.empty((S, M.on_rows_pad), dtype=dtype,
                                  device="cuda")
                fn = entry(bell_lib, name, dt, BELL_ARGS)
                W, A128 = M.bl_vals.shape[1:3]
                chosen = kernels.bell_warps(W)
                shapes = {w: {"warps": w} for w in BELL_WARPS}

                def launch(w):
                    return fn(M.bl_src.data_ptr(), M.bl_idx.data_ptr(),
                              M.bl_vals.data_ptr(), M.bl_cnt.data_ptr(),
                              x.data_ptr(), out.data_ptr(), S, W, A128,
                              M.on_rows_pad, x.shape[1], w, stream)
            else:
                out = torch.empty((S, M.rows_pad), dtype=dtype,
                                  device="cuda")
                T, KL = M.on_vals.shape[1:]
                Kp = KL // formats.LANE
                chosen = kernels.swellt_launch_shape(Kp)
                shapes = {}
                for key, lib in swellt_libs.items():
                    group, span = shape_of(lib, Kp)
                    shapes[(group, span)] = {
                        "group": group, "span": span,
                        "modelled_global_atomics":
                            kernels.swellt_modelled_global_atomics(
                                M.on_cols, M.on_vals, M.wl_ws, M.wl_cnt,
                                M.rows_pad, group, span),
                        "nnz": ops // 2}
                fns = {shape_of(lib, Kp): entry(lib, name, dt, SWELLT_ARGS)
                       for lib in swellt_libs.values()}

                def launch(shape):
                    out.zero_()          # as the wrapper's torch.zeros
                    return fns[shape](M.on_cols.data_ptr(),
                                      M.on_vals.data_ptr(),
                                      M.wl_ws.data_ptr(),
                                      M.wl_cnt.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), S, T, Kp, M.rows_pad,
                                      x.shape[1], stream)
            for shape, rec in shapes.items():
                if launch(shape):
                    raise RuntimeError(f"{label} {fmt} {dt} {rec}: launch "
                                       f"failed")
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                if err > chip_smoke.TOL[dt] * scale:
                    raise AssertionError(f"{label} {fmt} {dt} {rec}: max "
                                         f"abs err {err} of {scale}")
                rec = dict(row, **rec, rel_err=err / scale,
                           ms=chip_smoke.kernel_ms(
                               torch, lambda s=shape: launch(s)),
                           chosen=shape == chosen)
                print(json.dumps(rec), flush=True)
            del M, out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
