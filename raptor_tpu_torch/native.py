"""ctypes bindings to the repository's native setup kernels.

``csrc/setup_kernels.cpp`` (at the repository root) holds the sequential
graph algorithms of the reference's setup phase behind a C ABI. This module
compiles it, read-only, with the same flags as ``raptor_tpu.native``
(``g++ -O3 -march=native -ffp-contract=off``) into the port's git-ignored
build directory, and binds only the entry points the port's setup calls:
classical strength, the split pattern, the RS passes, the CLJP loop,
mark-strong, modified-classical interpolation, glibc ``rand()``, the
stencil assembly, the two SpGEMMs, the PMIS loop, extended+i
interpolation and its pattern bound. Both packages then build
bit-identical hierarchies. There is no Python fallback: if the build
fails, ``load`` raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = pathlib.Path(__file__).resolve().parent
SRC = _ROOT.parent / "csrc" / "setup_kernels.cpp"
BUILD_DIR = _ROOT / "_build"
SO = BUILD_DIR / "_setup_kernels.so"

_lib = None
_lock = threading.Lock()

I64 = ctypes.POINTER(ctypes.c_int64)
F64 = ctypes.POINTER(ctypes.c_double)
I8 = ctypes.POINTER(ctypes.c_int8)
_i64 = ctypes.c_int64


def _build() -> None:
    """Compile into a temporary file and rename it into place, so that
    processes building at the same time never load a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        # -ffp-contract=off: no FMA contraction, the same arithmetic as
        # raptor_tpu.native's build of the same source
        r = subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
             "-fPIC", str(SRC), "-o", tmp],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"building {SRC} failed:\n{r.stderr}")
        os.replace(tmp, SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not SO.exists() or SO.stat().st_mtime < SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(SO))
        lib.rs_first_pass.argtypes = [_i64] + [I64] * 6
        lib.rs_second_pass.argtypes = [_i64] + [I64] * 3
        lib.cljp_main_loop.argtypes = [_i64] * 2 + [I64] * 5 + [F64]
        lib.pmis_main_loop.argtypes = [_i64] + [I64] * 5 + [F64]
        lib.mark_strong.argtypes = [_i64] + [I64] * 4 + [I8]
        interp_args = [_i64, I64, I64, F64, I8, I64, I64, _i64, I64, I64,
                       F64]
        for fn in (lib.mod_classical_interp, lib.extended_interp):
            fn.argtypes = interp_args
            fn.restype = _i64
        lib.interp_pattern_bound.argtypes = [_i64, I64, I64, I8, I64]
        lib.interp_pattern_bound.restype = _i64
        lib.glibc_rand_doubles.argtypes = [_i64, _i64, F64]
        lib.spgemm_compute.argtypes = [_i64, _i64, I64, I64, F64, I64, I64,
                                       F64, ctypes.c_double, I64]
        lib.spgemm_compute.restype = _i64
        lib.spgemm_t_compute.argtypes = [_i64] * 3 + [
            I64, I64, F64, I64, I64, F64, ctypes.c_double, I64]
        lib.spgemm_t_compute.restype = _i64
        lib.spgemm_fetch.argtypes = [I64, F64]
        lib.classical_strength_csr.argtypes = [
            _i64, I64, I64, F64, ctypes.c_double, I64, _i64, I64, I64, F64]
        lib.classical_strength_csr.restype = _i64
        lib.split_pattern.argtypes = [_i64, _i64] + [I64] * 6
        lib.split_pattern.restype = _i64
        lib.stencil_csr.argtypes = [_i64, I64, _i64, I64, F64, I64, I64,
                                    I64, F64]
        lib.stencil_csr.restype = _i64
        lib.finalize_interp.argtypes = [_i64, _i64, I64, I64, F64, I64,
                                        _i64, I64]
        for fn in (lib.rs_first_pass, lib.rs_second_pass,
                   lib.cljp_main_loop, lib.pmis_main_loop, lib.mark_strong,
                   lib.glibc_rand_doubles, lib.spgemm_fetch,
                   lib.finalize_interp):
            fn.restype = None
        _lib = lib
        return _lib


def _p(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _f(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def rs_first_pass(indptr, indices, col_ptr, col_indices, weights, states):
    """Classical RS first pass (cf_splitting.cpp:92-232), in place on
    ``weights`` and ``states`` (both contiguous int64)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    col_ptr, col_indices = _c(col_ptr), _c(col_indices)
    lib.rs_first_pass(len(weights), _p(indptr, I64), _p(indices, I64),
                      _p(col_ptr, I64), _p(col_indices, I64),
                      _p(weights, I64), _p(states, I64))


def rs_second_pass(indptr, indices, states):
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    lib.rs_second_pass(len(indptr) - 1, _p(indptr, I64), _p(indices, I64),
                       _p(states, I64))


def cljp_main_loop(indptr, indices, col_ptr, col_indices, states, weights):
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    col_ptr, col_indices = _c(col_ptr), _c(col_indices)
    lib.cljp_main_loop(len(states), len(indices), _p(indptr, I64),
                       _p(indices, I64), _p(col_ptr, I64),
                       _p(col_indices, I64), _p(states, I64),
                       _p(weights, F64))


def mark_strong(a_indptr, a_indices, s_indptr, s_indices, n):
    """int8 flags over A's entries that appear in S's pattern."""
    lib = load()
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    s_indptr, s_indices = _c(s_indptr), _c(s_indices)
    strong = np.zeros(len(a_indices), dtype=np.int8)
    lib.mark_strong(n, _p(a_indptr, I64), _p(a_indices, I64),
                    _p(s_indptr, I64), _p(s_indices, I64), _p(strong, I8))
    return strong


def pmis_main_loop(indptr, indices, col_ptr, col_indices, states,
                   weights):
    """PMIS independent-set loop (cf_splitting.cpp:578-665), in place on
    ``states`` (int64) and ``weights`` (float64)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    col_ptr, col_indices = _c(col_ptr), _c(col_indices)
    lib.pmis_main_loop(len(states), _p(indptr, I64), _p(indices, I64),
                       _p(col_ptr, I64), _p(col_indices, I64),
                       _p(states, I64), _p(weights, F64))


def _interp(fn, a_indptr, a_indices, a_data, strong, states, bound):
    """Run one single-variable interpolation kernel into triplet buffers of
    ``bound`` entries; returns the row-ordered (rows, cols, vals)."""
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    a_data = _f(a_data)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    variables, num_variables = np.zeros(1, dtype=np.int64), 1
    rows = np.empty(bound, dtype=np.int64)
    cols = np.empty(bound, dtype=np.int64)
    vals = np.empty(bound, dtype=np.float64)
    nnz = fn(len(a_indptr) - 1, _p(a_indptr, I64), _p(a_indices, I64),
             _p(a_data, F64), _p(strong, I8), _p(states, I64),
             _p(variables, I64), num_variables, _p(rows, I64),
             _p(cols, I64), _p(vals, F64))
    return rows[:nnz], cols[:nnz], vals[:nnz]


def mod_classical_interp(a_indptr, a_indices, a_data, strong, states):
    """Row-ordered (rows, cols, vals) triplets of single-variable
    modified-classical P (par_interpolation.cpp:1012-1400)."""
    return _interp(load().mod_classical_interp, a_indptr, a_indices, a_data,
                   strong, states, len(a_indices) + len(a_indptr))


def extended_interp(a_indptr, a_indices, a_data, strong, states, bound):
    """Row-ordered (rows, cols, vals) triplets of single-variable
    extended+i P with the production semantics
    (par_interpolation.cpp:301-1010); columns come unsorted within a row.
    ``bound`` is ``interp_pattern_bound`` of the same inputs."""
    return _interp(load().extended_interp, a_indptr, a_indices, a_data,
                   strong, states, bound)


def interp_pattern_bound(a_indptr, a_indices, strong, states) -> int:
    """Entry-count bound of the extended+i distance-2 pattern (one C pass
    over A's entries; ``strong`` int8, ``states`` CF states)."""
    lib = load()
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    return int(lib.interp_pattern_bound(
        len(a_indptr) - 1, _p(a_indptr, I64), _p(a_indices, I64),
        _p(strong, I8), _p(states, I64)))


def finalize_interp(n, rows, cols, vals, col_map, do_sort):
    """Triplets (row-ordered, unique cols per row) -> CSR arrays with
    columns mapped through ``col_map``, sorted per row when asked."""
    lib = load()
    rows, cols, col_map = _c(rows), _c(cols), _c(col_map)
    vals = _f(vals)
    indptr = np.empty(n + 1, dtype=np.int64)
    lib.finalize_interp(n, len(rows), _p(rows, I64), _p(cols, I64),
                        _p(vals, F64), _p(col_map, I64), int(do_sort),
                        _p(indptr, I64))
    return indptr, cols.copy(), vals.copy()


def glibc_rand_doubles(seed: int, n: int) -> np.ndarray:
    lib = load()
    out = np.empty(n, dtype=np.float64)
    lib.glibc_rand_doubles(seed, n, _p(out, F64))
    return out


def classical_strength_csr(indptr, indices, data, theta):
    """Single-variable classical strength S as a CSR (threshold + compress
    in one pass)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    data = _f(data)
    n = len(indptr) - 1
    variables, num_variables = np.zeros(1, dtype=np.int64), 1
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(len(indices), dtype=np.int64)
    out_data = np.empty(len(indices))
    m = lib.classical_strength_csr(
        n, _p(indptr, I64), _p(indices, I64), _p(data, F64), float(theta),
        _p(variables, I64), int(num_variables), _p(out_indptr, I64),
        _p(out_indices, I64), _p(out_data, F64))
    return out_indptr, out_indices[:m], out_data[:m]


def split_pattern(indptr, indices, n_rows, n_cols):
    """Diag-stripped CSR pattern + its CSC transpose in one C pass:
    (indptr, indices, col_ptr, col_indices)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    nnz = len(indices)
    out_indptr = np.empty(n_rows + 1, dtype=np.int64)
    out_indices = np.empty(nnz, dtype=np.int64)
    col_ptr = np.empty(n_cols + 1, dtype=np.int64)
    col_indices = np.empty(nnz, dtype=np.int64)
    m = lib.split_pattern(n_rows, n_cols, _p(indptr, I64), _p(indices, I64),
                          _p(out_indptr, I64), _p(out_indices, I64),
                          _p(col_ptr, I64), _p(col_indices, I64))
    return out_indptr, out_indices[:m], col_ptr, col_indices[:m]


def stencil_csr(grid, dcols, dvals, offs):
    """Direct CSR assembly of a constant-stencil grid operator; ``dcols``
    ascending column offsets, ``offs`` [K, dim] per-dimension steps."""
    lib = load()
    grid = _c(grid)
    n_v = int(np.prod(grid))
    K = len(dcols)
    dcols, offs, dvals = _c(dcols), _c(offs), _f(dvals)
    indptr = np.empty(n_v + 1, dtype=np.int64)
    indices = np.empty(n_v * K, dtype=np.int64)
    data = np.empty(n_v * K, dtype=np.float64)
    nnz = lib.stencil_csr(len(grid), _p(grid, I64), K, _p(dcols, I64),
                          _p(dvals, F64), _p(offs, I64), _p(indptr, I64),
                          _p(indices, I64), _p(data, F64))
    return indptr, indices[:nnz], data[:nnz]


def _spgemm_out(lib, nnz):
    c_indices = np.empty(nnz, dtype=np.int64)
    c_data = np.empty(nnz, dtype=np.float64)
    lib.spgemm_fetch(_p(c_indices, I64), _p(c_data, F64))
    return c_indices, c_data


def spgemm(n_rows, n_cols_b, a_indptr, a_indices, a_data,
           b_indptr, b_indices, b_data, zero_tol):
    """C = A @ B (CSR), sorted cols, |c| <= zero_tol dropped."""
    lib = load()
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    b_indptr, b_indices = _c(b_indptr), _c(b_indices)
    a_data, b_data = _f(a_data), _f(b_data)
    c_indptr = np.zeros(n_rows + 1, dtype=np.int64)
    nnz = lib.spgemm_compute(
        n_rows, n_cols_b, _p(a_indptr, I64), _p(a_indices, I64),
        _p(a_data, F64), _p(b_indptr, I64), _p(b_indices, I64),
        _p(b_data, F64), zero_tol, _p(c_indptr, I64))
    return (c_indptr,) + _spgemm_out(lib, nnz)


def spgemm_T(n_rows_a, n_cols_a, n_cols_b, a_indptr, a_indices, a_data,
             b_indptr, b_indices, b_data, zero_tol):
    """C = A^T @ B (CSR inputs, no explicit transpose), sorted cols,
    |c| <= zero_tol dropped."""
    lib = load()
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    b_indptr, b_indices = _c(b_indptr), _c(b_indices)
    a_data, b_data = _f(a_data), _f(b_data)
    c_indptr = np.zeros(n_cols_a + 1, dtype=np.int64)
    nnz = lib.spgemm_t_compute(
        n_rows_a, n_cols_a, n_cols_b, _p(a_indptr, I64),
        _p(a_indices, I64), _p(a_data, F64), _p(b_indptr, I64),
        _p(b_indices, I64), _p(b_data, F64), zero_tol, _p(c_indptr, I64))
    return (c_indptr,) + _spgemm_out(lib, nnz)
