"""Hand-written CUDA kernels of the solve path, and their wrappers.

Five kernels carry the SpMVs of the solve, one per device format:

- ``dia_spmv`` (``csrc/dia_spmv.cu``) replaces
  ``raptor_tpu/device/pallas_kernels.py:dia_spmv_pallas``: stencil operators
  (the fine levels), DIA-shaped embedded transfer operators and the f64
  fine-level residual of mixed-precision refinement. Bound: memory, about
  ``(K + 2) * R * itemsize`` bytes per shard.
- ``bdia_spmv`` (``csrc/bdia_spmv.cu``) replaces
  ``pallas_kernels.py:bdia_spmv_pallas``: coarse Galerkin operators and the
  embedded P / P^T. It walks only the non-empty (plane, 128-row block)
  tiles that ``formats.bdia_tiles`` lists. Bound: memory, about
  ``tiles * 128 * (itemsize + 1) + 2 * R * itemsize`` bytes per shard.
- ``wind_ell_spmv`` (``csrc/wind_ell_spmv.cu``) replaces
  ``pallas_kernels.py:wind_ell_spmv_pallas``: the 3-D transfer operators
  and ELL-headed coarse operators. It reads the sliced copy of the layout
  (``formats.well_slices``): the real entries only, a warp per 32-row
  slice of rows sorted by length. Bound: memory, about ``E * (c +
  itemsize) + 2 * R + 4 * R / 32 + (C + rows) * itemsize`` bytes per
  shard, ``E`` sliced entries, ``c`` 2 or 4 bytes a column.
- ``swellt_spmv_T`` (``csrc/swellt_spmv_T.cu``) replaces
  ``pallas_kernels.py:swellt_spmv_T_pallas``: restriction operators in the
  sorted-scatter layout. A CTA sums a group of source tiles into a
  shared-memory window and flushes it with one global atomic add per
  target it touched; the group size and the window are constants of the
  source. It reads only the real entries of each slot
  (``formats.swellt_counts``). Bound: memory, about ``E * (4 + itemsize)
  + 8 * T * Kp + (C + n_out) * itemsize`` bytes per shard, ``E`` real
  entries.
- ``bell_spmv`` (``csrc/bell_spmv.cu``) replaces
  ``pallas_kernels.py:bell_spmv_pallas``: block-ELL of plane slots. It
  reads only the real slots of each row block (``formats.bell_counts``).
  Bound: memory, about ``N * (128 * (1 + itemsize) + 4) + 4 * A128 +
  (C + rows) * itemsize`` bytes per shard, ``N`` real slots.

Each is written in CUDA C++ for ``sm_90a``, templated on float and double,
built with ``nvcc`` into a shared library with a plain C interface at first
CUDA use (one ``nvcc`` per source, all started together), and bound with
``ctypes``. A kernel launches on PyTorch's current stream and allocates
nothing; the wrapper allocates the output, checks device, dtype, shape and
contiguity, raises if the launch reports an error, and counts its launches
in ``LAUNCHES``.

When every tensor argument lies on the CPU, a wrapper runs the kernel's
plain PyTorch version (``device.formats``, same name; for windowed ELL
``well_slices_spmv``, over the same sliced arrays). Otherwise it
launches the kernel on CUDA tensors or raises (for a mix of devices too);
it never falls back to the plain version.
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
import torch.nn.functional as F

from raptor_tpu_torch.device import formats
from raptor_tpu_torch.profiling.timers import BUILDS

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("dia_spmv", "bdia_spmv", "wind_ell_spmv",
                        "swellt_spmv_T", "bell_spmv")}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# planes a BDIA row block can list (kMaxTiles in csrc/bdia_spmv.cu; the
# packer's cap, device/par.py:MAX_BDIA_PLANES, is no larger)
BDIA_MAX_PLANES = 1024

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
    # idx, vals, x, d_offsets, tptr, tplane, out, S, P, A_pad, rows, C,
    # Tmax, stream
    "bdia_spmv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _L, _P],
    # ws, perm, sptr, crel, cvals, x, out, S, n_tiles, tile_rows, E, rows,
    # C, col_bytes, stream
    "wind_ell_spmv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L,
                      _I, _P],
    # meta, vals, qb, cnt, x, out, S, n_tiles, Kp, n_out, C, stream
    "swellt_spmv_T": [_P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _L, _P],
    # src, idx, vals, cnt, x, out, S, W, A128, rows, C, warps, stream
    "bell_spmv": [_P, _P, _P, _P, _P, _P, _I, _I, _L, _L, _L, _I, _P],
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
    half a library. Raises with the compiler's output on failure. A build
    is the phase "kernels.build" of ``profiling.timers.BUILDS`` (the span
    ``raptor.kernels.build``), each nvcc run one of its ``builds``."""
    with _lock:
        stale = [n for n, src in SOURCES.items()
                 if not _so(n).exists()
                 or _so(n).stat().st_mtime < src.stat().st_mtime]
        if not stale:
            return
        with BUILDS.phase("kernels.build"):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cc = nvcc()
            jobs = []
            for name in stale:
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                proc = subprocess.Popen(
                    [cc, *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs.append((name, tmp, proc))
                BUILDS.tally("builds")
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


def _all_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: only then does a wrapper run
    the plain version; any other mix goes to ``_check_cuda``, which raises
    for it."""
    return all(t.device.type == "cpu" for t in tensors)


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
    if _all_cpu(offsets_dev, vals, x):
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
              padb: int, rows_pad: int, tptr: torch.Tensor,
              tplane: torch.Tensor) -> torch.Tensor:
    """``out[s, a*128 + l] = sum_p vals[s,p,a,l] * x[s, (a + d_p)*128 +
    idx[s,p,a,l]]`` with x zero outside [0, C). ``idx`` int8 and ``vals``
    ``[S, P, A_pad, 128]``, ``x [S, C]``; ``d_offsets_dev`` is
    ``d_offsets`` as an int32 tensor; ``tptr [S, nblk + 1]`` and ``tplane
    [S, Tmax]`` (int32, ``nblk = ceil(rows_pad / 128)``) list the tiles
    that hold a nonzero (``formats.bdia_tiles``). The kernel sums the
    listed tiles only; the plain version sums every plane and ignores the
    list. Returns ``[S, rows_pad]``."""
    if _all_cpu(d_offsets_dev, idx, vals, x, tptr, tplane):
        return formats.bdia_spmv(d_offsets, idx, vals, x, padb, rows_pad)
    _check_cuda("bdia_spmv", x, {"idx": idx, "vals": vals, "x": x,
                                 "d_offsets": d_offsets_dev, "tptr": tptr,
                                 "tplane": tplane})
    S, P, A_pad, L = vals.shape
    if (vals.dtype != x.dtype or idx.dtype != torch.int8
            or idx.shape != vals.shape or L != formats.LANE
            or x.dim() != 2 or x.shape[0] != S or x.shape[1] == 0
            or not 0 < rows_pad <= A_pad * L):
        raise ValueError(f"bdia_spmv: idx {tuple(idx.shape)} {idx.dtype}, "
                         f"vals {tuple(vals.shape)} {vals.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}, rows_pad {rows_pad}")
    if d_offsets_dev.dtype != torch.int32 or d_offsets_dev.shape != (P,):
        raise ValueError(f"bdia_spmv: offsets {tuple(d_offsets_dev.shape)} "
                         f"{d_offsets_dev.dtype}, want ({P},) int32")
    if P > BDIA_MAX_PLANES:
        raise ValueError(f"bdia_spmv: {P} planes; the kernel stages a row "
                         f"block's list of at most {BDIA_MAX_PLANES} in "
                         f"shared memory")
    _int32("bdia_spmv", "tptr", tptr, (S, -(-rows_pad // L) + 1))
    if (tplane.dtype != torch.int32 or tplane.dim() != 2
            or tplane.shape[0] != S or tplane.shape[1] < 1):
        raise ValueError(f"bdia_spmv: tplane {tuple(tplane.shape)} "
                         f"{tplane.dtype}, want ({S}, >= 1) int32")
    # a tile's values and lane ids load as 16- and 4-byte vectors
    if vals.data_ptr() % 16 or idx.data_ptr() % 4:
        raise ValueError("bdia_spmv: vals must be 16-byte and idx 4-byte "
                         "aligned")
    out = torch.empty((S, rows_pad), dtype=x.dtype, device=x.device)
    _launch("bdia_spmv", x, idx.data_ptr(), vals.data_ptr(), x.data_ptr(),
            d_offsets_dev.data_ptr(), tptr.data_ptr(), tplane.data_ptr(),
            out.data_ptr(), S, P, A_pad, rows_pad, x.shape[1],
            tplane.shape[1])
    return out


def _int32(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {arg} {tuple(t.shape)} {t.dtype}, want "
                         f"{tuple(shape)} int32")


def wind_ell_spmv(ws: torch.Tensor, perm: torch.Tensor, sptr: torch.Tensor,
                  crel: torch.Tensor, cvals: torch.Tensor, x: torch.Tensor,
                  ba: int, rows_pad: int) -> torch.Tensor:
    """The windowed-ELL product from its sliced layout
    (``formats.well_slices``): ``out[s, r] = sum over the entries of row r
    of cvals * x[s, ws[s, r // (ba*128)]*128 + crel]`` with x zero outside
    [0, C). ``ws [S, T]`` int32, ``perm [S, R]`` int16 with ``R = T * ba *
    128``, ``sptr [S, R/32 + 1]`` int32, ``crel`` (int16 or int32) and
    ``cvals [S, E]`` with ``E`` a multiple of 32 and at least each shard's
    ``sptr[s, -1] * 32`` (not checked: it lies on the card), ``x [S, C]``;
    the kernel indexes a shard with 32-bit offsets, so R, E and C stay
    below 2^31.
    Returns ``[S, rows_pad]``; each row sums its entries in slot order."""
    if _all_cpu(ws, perm, sptr, crel, cvals, x):
        return formats.well_slices_spmv(ws, perm, sptr, crel, cvals, x, ba,
                                        rows_pad)
    _check_cuda("wind_ell_spmv", x, {"ws": ws, "perm": perm, "sptr": sptr,
                                     "crel": crel, "cvals": cvals, "x": x})
    S, R = perm.shape
    tile_rows = ba * formats.LANE
    SL = formats.WELL_SLICE
    if (x.dim() != 2 or x.shape[0] != S or x.shape[1] == 0
            or R % tile_rows or not 0 < rows_pad <= R
            or cvals.dtype != x.dtype or cvals.dim() != 2
            or cvals.shape[0] != S or cvals.shape[1] % SL
            or cvals.shape[1] == 0 or crel.shape != cvals.shape
            or crel.dtype not in (torch.int16, torch.int32)
            or perm.dtype != torch.int16 or tile_rows > 1 << 15
            or max(R, cvals.shape[1], x.shape[1]) >= 1 << 31):
        raise ValueError(f"wind_ell_spmv: perm {tuple(perm.shape)} "
                         f"{perm.dtype}, crel {tuple(crel.shape)} "
                         f"{crel.dtype}, cvals {tuple(cvals.shape)} "
                         f"{cvals.dtype}, x {tuple(x.shape)} {x.dtype}, "
                         f"tile {tile_rows}, rows_pad {rows_pad}")
    _int32("wind_ell_spmv", "ws", ws, (S, R // tile_rows))
    _int32("wind_ell_spmv", "sptr", sptr, (S, R // SL + 1))
    out = torch.empty((S, rows_pad), dtype=x.dtype, device=x.device)
    _launch("wind_ell_spmv", x, ws.data_ptr(), perm.data_ptr(),
            sptr.data_ptr(), crel.data_ptr(), cvals.data_ptr(), x.data_ptr(),
            out.data_ptr(), S, R // tile_rows, tile_rows, cvals.shape[1],
            rows_pad, x.shape[1], crel.element_size())
    return out


def swellt_spmv_T(meta: torch.Tensor, vals: torch.Tensor, qb: torch.Tensor,
                  x: torch.Tensor, n_out: int,
                  cnt: torch.Tensor) -> torch.Tensor:
    """``y = B^T x`` from the sorted-scatter layout: ``y[s, (qb[s, t*Kp +
    e//128] + qrel)*128 + lout] += vals[s,t,e] * x[s, t*128 + srcl]`` with
    ``meta = srcl | qrel << 7 | lout << 12``. ``meta`` int32 and ``vals``
    ``[S, T, Kp*128]``, ``qb`` and ``cnt [S, T*Kp]`` int32 (``cnt``: the
    real entries of each slot, ``formats.swellt_counts``), ``x [S, C]``.
    The kernel reads no entry of a slot past its count; the plain version
    reads every entry and ignores ``cnt``. Returns ``[S, n_out]``; the
    float sum order varies between runs (atomics)."""
    if _all_cpu(meta, vals, qb, x, cnt):
        return formats.swellt_spmv_T(meta, vals, qb, x, n_out)
    _check_cuda("swellt_spmv_T", x, {"meta": meta, "vals": vals, "qb": qb,
                                     "x": x, "cnt": cnt})
    S, T, KL = vals.shape
    if (vals.dtype != x.dtype or x.dim() != 2 or x.shape[0] != S
            or KL % formats.LANE or n_out <= 0):
        raise ValueError(f"swellt_spmv_T: vals {tuple(vals.shape)} "
                         f"{vals.dtype}, x {tuple(x.shape)} {x.dtype}, "
                         f"n_out {n_out}")
    Kp = KL // formats.LANE
    _int32("swellt_spmv_T", "meta", meta, vals.shape)
    _int32("swellt_spmv_T", "qb", qb, (S, T * Kp))
    _int32("swellt_spmv_T", "cnt", cnt, (S, T * Kp))
    out = torch.zeros((S, n_out), dtype=x.dtype, device=x.device)
    _launch("swellt_spmv_T", x, meta.data_ptr(), vals.data_ptr(),
            qb.data_ptr(), cnt.data_ptr(), x.data_ptr(), out.data_ptr(), S,
            T, Kp, n_out, x.shape[1])
    return out


def swellt_launch_shape(Kp: int) -> Tuple[int, int]:
    """(source tiles a CTA sums, 128-blocks of its shared accumulator) of
    the sorted-scatter kernel for ``Kp`` slots a tile, read from the built
    kernel library, whose source fixes both. Needs ``nvcc``."""
    fn = _lib("swellt_spmv_T").swellt_spmv_T_shape
    fn.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    fn.restype = None
    group, span = _I(), _I()
    fn(Kp, ctypes.byref(group), ctypes.byref(span))
    return group.value, span.value


def swellt_modelled_global_atomics(meta: torch.Tensor, vals: torch.Tensor,
                                   qb: torch.Tensor, cnt: torch.Tensor,
                                   n_out: int, group: int, span: int) -> int:
    """A host model of the global atomic adds of one ``swellt_spmv_T``
    launch with ``group`` tiles a CTA and a ``span``-block accumulator
    (``swellt_launch_shape``), counted from the packed arrays and not read
    from the card: per CTA (``group`` consecutive source tiles of one
    shard), one for each distinct target inside its accumulator (``span``
    128-blocks from the least window base of its slots that hold an entry),
    and one for each entry outside it. Entries past a slot's count, of
    value 0 or aimed at or past ``n_out`` add nothing. An upper bound: a
    shared sum that cancels to exactly 0 is not flushed."""
    S, T, KL = vals.shape
    Kp = KL // formats.LANE
    G = group
    ng = -(-T // G)
    c = cnt.reshape(S, T, Kp).long()
    q = qb.reshape(S, T, Kp).long()
    m = meta.reshape(S, T, Kp, formats.LANE).long()
    lane = torch.arange(formats.LANE, device=vals.device)
    tgt = ((q[..., None] + ((m >> 7) & (formats.SWELLT_AMAX - 1)))
           * formats.LANE + ((m >> 12) & 127))
    live = ((lane < c[..., None])
            & (vals.reshape(S, T, Kp, formats.LANE) != 0) & (tgt < n_out))
    big = torch.iinfo(torch.int64).max
    qmin = torch.where(c > 0, q, big).amin(dim=2)               # [S, T]
    qmin = F.pad(qmin, (0, ng * G - T), value=big)
    base = qmin.reshape(S, ng, G).amin(dim=2)                   # [S, ng]
    grp = torch.arange(T, device=vals.device) // G
    # (a group with no entry keeps the sentinel; cut it below overflow)
    lo = base[:, grp].clamp(max=1 << 40) * formats.LANE         # [S, T]
    local = tgt - lo[:, :, None, None]
    inside = live & (local >= 0) & (local < span * formats.LANE)
    key = ((torch.arange(S, device=vals.device)[:, None] * ng + grp)
           [:, :, None, None] * n_out + tgt)
    return (int((live & ~inside).sum())
            + int(torch.unique(key[inside]).numel()))


# BELL warps per row block by the fullest block's slots: the smallest of
# 4, 8 and 16 warps (the counts the kernel is built for; chip_sweep.py
# times each, PERF.md) that leaves each at most BELL_SLOTS_PER_WARP, else 16
BELL_SLOTS_PER_WARP = 16


def bell_warps(W: int) -> int:
    """Warps of a CTA of the BELL kernel for a layout of ``W`` slots per
    row block (the fullest block's count): one row block per CTA, so a
    layout with hundreds of slots in a block takes 16 warps and one with
    a few dozen 4."""
    for warps in (4, 8):
        if warps * BELL_SLOTS_PER_WARP >= W:
            return warps
    return 16


def bell_spmv(src: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              x: torch.Tensor, rows_pad: int,
              cnt: torch.Tensor) -> torch.Tensor:
    """``out[s, a*128 + l] = sum_w vals[s,w,a,l] * x[s, src[s,w,a]*128 +
    idx[s,w,a,l]]`` with x zero outside [0, C). ``src [S, W, A128]`` int32,
    ``idx`` int8 and ``vals [S, W, A128, 128]``, ``cnt [S, A128]`` int32
    (the real slots of each row block, ``formats.bell_counts``), ``x [S,
    C]``. The kernel reads no slot of a block past its count; the plain
    version reads every slot and ignores ``cnt``. Returns ``[S,
    rows_pad]``."""
    if _all_cpu(src, idx, vals, x, cnt):
        return formats.bell_spmv(src, idx, vals, x, rows_pad)
    _check_cuda("bell_spmv", x, {"src": src, "idx": idx, "vals": vals,
                                 "x": x, "cnt": cnt})
    S, W, A128, L = vals.shape
    if (vals.dtype != x.dtype or idx.dtype != torch.int8
            or idx.shape != vals.shape or L != formats.LANE
            or x.dim() != 2 or x.shape[0] != S
            or not 0 < rows_pad <= A128 * L):
        raise ValueError(f"bell_spmv: idx {tuple(idx.shape)} {idx.dtype}, "
                         f"vals {tuple(vals.shape)} {vals.dtype}, x "
                         f"{tuple(x.shape)} {x.dtype}, rows_pad {rows_pad}")
    _int32("bell_spmv", "src", src, (S, W, A128))
    _int32("bell_spmv", "cnt", cnt, (S, A128))
    # a slot's values and lane ids load as 16- and 4-byte vectors
    if vals.data_ptr() % 16 or idx.data_ptr() % 4:
        raise ValueError("bell_spmv: vals must be 16-byte and idx 4-byte "
                         "aligned")
    out = torch.empty((S, rows_pad), dtype=x.dtype, device=x.device)
    _launch("bell_spmv", x, src.data_ptr(), idx.data_ptr(), vals.data_ptr(),
            cnt.data_ptr(), x.data_ptr(), out.data_ptr(), S, W, A128,
            rows_pad, x.shape[1], bell_warps(W))
    return out
