"""Hand-written CUDA kernels of the solve path, and their wrappers.

Two kernels carry the SpMVs of the flagship 2-D solve, one per format:

- ``dia_spmv`` (``csrc/dia_spmv.cu``) replaces
  ``raptor_tpu/device/pallas_kernels.py:dia_spmv_pallas``: stencil operators
  (the fine levels), DIA-shaped embedded transfer operators and the f64
  fine-level residual of mixed-precision refinement. Bound: memory, about
  ``(K + 2) * R * itemsize`` bytes per shard.
- ``bdia_spmv`` (``csrc/bdia_spmv.cu``) replaces
  ``pallas_kernels.py:bdia_spmv_pallas``: coarse Galerkin operators and the
  embedded P / P^T. Bound: memory, about
  ``P * A_pad * 128 * (itemsize + 1) + 2 * R * itemsize`` bytes per shard.

Each is written in CUDA C++ for ``sm_90a``, templated on float and double,
built with ``nvcc`` into a shared library with a plain C interface at first
CUDA use (one ``nvcc`` per source, all started together), and bound with
``ctypes``. A kernel launches on PyTorch's current stream and allocates
nothing; the wrapper allocates the output, checks device, dtype, shape and
contiguity, raises if the launch reports an error, and counts its launches
in ``LAUNCHES``.

On CPU tensors a wrapper runs the kernel's plain PyTorch version
(``device.formats.dia_spmv`` / ``bdia_spmv``). On a CUDA tensor it launches
the kernel or raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import torch

from raptor_tpu_torch.device import formats

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {"dia_spmv": CSRC / "dia_spmv.cu", "bdia_spmv": CSRC / "bdia_spmv.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# launches of each kernel since the last reset_launches()
LAUNCHES = {name: 0 for name in SOURCES}

_libs = {}
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = {
    # vals, x, offsets, out, S, K, R, C, stream
    "dia_spmv": [_P, _P, _P, _P, _I, _I, _L, _L, _P],
    # idx, vals, x, d_offsets, out, S, P, A_pad, rows, C, stream
    "bdia_spmv": [_P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _so(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def build() -> None:
    """Compile every kernel whose library is missing or older than its
    source: one ``nvcc`` per source, all running at once. Each compiles to
    a temporary file renamed into place, so a concurrent loader never sees
    half a library. Raises with the compiler's output on failure."""
    with _lock:
        stale = [n for n, src in SOURCES.items()
                 if not _so(n).exists()
                 or _so(n).stat().st_mtime < src.stat().st_mtime]
        if not stale:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = nvcc()
        jobs = []
        for name in stale:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [cc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((name, tmp, proc))
        errors = []
        for name, tmp, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, _so(name))
            else:
                os.unlink(tmp)
                errors.append(f"nvcc {SOURCES[name].name} failed "
                              f"(rc {proc.returncode}):\n{log}")
        if errors:
            raise RuntimeError("\n".join(errors))


def _lib(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_so(name)))
            for dt in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{dt}")
                fn.argtypes = _ARGTYPES[name]
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def _launch(name: str, x: torch.Tensor, *args) -> None:
    suffix = {torch.float32: "f32", torch.float64: "f64"}[x.dtype]
    fn = getattr(_lib(name), f"{name}_{suffix}")
    err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check_cuda(name: str, x: torch.Tensor, tensors: dict) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x lies on {x.device}; the kernel takes "
                         f"CUDA tensors and its plain version CPU tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: x lies on {x.device}, the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {x.dtype}; the kernel takes "
                        f"float32 and float64")
    for arg, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} lies on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def dia_spmv(offsets: Tuple[int, ...], offsets_dev: torch.Tensor,
             vals: torch.Tensor, x: torch.Tensor, pad: int) -> torch.Tensor:
    """``b[s, i] = sum_k vals[s, k, i] * x[s, i + offsets[k]]`` with x zero
    outside [0, C). ``vals [S, K, R]``, ``x [S, C]``; ``offsets_dev`` is
    ``offsets`` as an int32 tensor beside ``vals``. Returns ``[S, R]``."""
    if x.device.type == "cpu":
        return formats.dia_spmv(offsets, vals, x, pad)
    _check_cuda("dia_spmv", x, {"vals": vals, "x": x,
                                "offsets": offsets_dev})
    S, K, R = vals.shape
    if vals.dtype != x.dtype or x.dim() != 2 or x.shape[0] != S:
        raise ValueError(f"dia_spmv: vals {tuple(vals.shape)} {vals.dtype}"
                         f" vs x {tuple(x.shape)} {x.dtype}")
    if offsets_dev.dtype != torch.int32 or offsets_dev.shape != (K,):
        raise ValueError(f"dia_spmv: offsets {tuple(offsets_dev.shape)} "
                         f"{offsets_dev.dtype}, want ({K},) int32")
    out = torch.empty((S, R), dtype=x.dtype, device=x.device)
    _launch("dia_spmv", x, vals.data_ptr(), x.data_ptr(),
            offsets_dev.data_ptr(), out.data_ptr(), S, K, R, x.shape[1])
    return out


def bdia_spmv(d_offsets: Tuple[int, ...], d_offsets_dev: torch.Tensor,
              idx: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
              padb: int, rows_pad: int) -> torch.Tensor:
    """``out[s, a*128 + l] = sum_p vals[s,p,a,l] * x[s, (a + d_p)*128 +
    idx[s,p,a,l]]`` with x zero outside [0, C). ``idx`` int8 and ``vals``
    ``[S, P, A_pad, 128]``, ``x [S, C]``; ``d_offsets_dev`` is
    ``d_offsets`` as an int32 tensor. Returns ``[S, rows_pad]``."""
    if x.device.type == "cpu":
        return formats.bdia_spmv(d_offsets, idx, vals, x, padb, rows_pad)
    _check_cuda("bdia_spmv", x, {"idx": idx, "vals": vals, "x": x,
                                 "d_offsets": d_offsets_dev})
    S, P, A_pad, L = vals.shape
    if (vals.dtype != x.dtype or idx.dtype != torch.int8
            or idx.shape != vals.shape or L != formats.LANE
            or x.dim() != 2 or x.shape[0] != S
            or not 0 < rows_pad <= A_pad * L):
        raise ValueError(f"bdia_spmv: idx {tuple(idx.shape)} {idx.dtype}, "
                         f"vals {tuple(vals.shape)} {vals.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}, rows_pad {rows_pad}")
    if d_offsets_dev.dtype != torch.int32 or d_offsets_dev.shape != (P,):
        raise ValueError(f"bdia_spmv: offsets {tuple(d_offsets_dev.shape)} "
                         f"{d_offsets_dev.dtype}, want ({P},) int32")
    out = torch.empty((S, rows_pad), dtype=x.dtype, device=x.device)
    _launch("bdia_spmv", x, idx.data_ptr(), vals.data_ptr(), x.data_ptr(),
            d_offsets_dev.data_ptr(), out.data_ptr(), S, P, A_pad, rows_pad,
            x.shape[1])
    return out
