"""ctypes bindings to the repository's native setup kernels.

``csrc/setup_kernels.cpp`` (at the repository root) holds the sequential
graph algorithms of the reference's setup phase behind a C ABI. This module
compiles it, read-only, with the same flags as ``raptor_tpu.native``
(``g++ -O3 -march=native -ffp-contract=off``) into the port's git-ignored
build directory, and binds only the entry points the port's setup calls:
classical (scalar or unknown-based) and symmetric strength, the split
pattern, the RS passes, the CLJP loop, mark-strong, modified-classical
interpolation, glibc ``rand()``, the stencil assembly, the two SpGEMMs,
the PMIS loop, extended+i interpolation and its pattern bound, the
operand packing of the device
interpolation engines, the smoothers' greedy colouring and triangular
level schedule, smoothed aggregation's MIS(2) and aggregation passes,
the per-round weight update of the distributed CLJP splitting, the
per-round steps of the distributed MIS(2) and aggregation, and the
multilevel k-way graph partitioner. Both packages
then build
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
I32 = ctypes.POINTER(ctypes.c_int32)
F64 = ctypes.POINTER(ctypes.c_double)
I8 = ctypes.POINTER(ctypes.c_int8)
_i64 = ctypes.c_int64


def _build() -> None:
    """Compile into a temporary file and rename it into place, so that
    processes building at the same time never load a half-written file.
    The build is the phase "native.build" of ``profiling.timers.BUILDS``
    (the span ``raptor.native.build``), one of its ``builds``."""
    from raptor_tpu_torch.profiling.timers import BUILDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        with BUILDS.phase("native.build"):
            BUILDS.tally("builds")
            # -ffp-contract=off: no FMA contraction, the same arithmetic
            # as raptor_tpu.native's build of the same source
            r = subprocess.run(
                ["g++", "-O3", "-march=native", "-ffp-contract=off",
                 "-shared", "-fPIC", str(SRC), "-o", tmp],
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
        lib.symmetric_strength_csr.argtypes = [
            _i64, I64, I64, F64, ctypes.c_double, I64, I64, F64]
        lib.symmetric_strength_csr.restype = _i64
        lib.mis2.argtypes = [_i64] + [I64] * 4 + [F64, I64]
        lib.partition_kway.argtypes = [_i64, I64, I64, F64, _i64, I64]
        lib.partition_kway.restype = _i64
        lib.dist_cljp_update.argtypes = [_i64] * 3 + [I64] * 13 + [F64] * 2
        lib.dist_mis2_step1.argtypes = [_i64] + [I64] * 4 + [F64, F64, I64,
                                                             I64]
        lib.dist_mis2_step2.argtypes = ([_i64] * 2 + [I64] * 6
                                        + [F64, F64, I64, I64, _i64, I64,
                                           F64, I64])
        lib.dist_mis2_steps34.argtypes = [_i64] * 2 + [I64] * 8 + [
            _i64, I64, I64]
        lib.dist_aggregate_pass1.argtypes = [_i64] * 2 + [I64] * 9
        lib.dist_aggregate_pass2.argtypes = (
            [_i64] + [I64] * 6 + [F64] + [I64] * 2 + [F64] + [I64] * 2
            + [F64] * 2 + [I64] * 2)
        lib.aggregate.argtypes = [_i64] + [I64] * 4 + [F64, I64, F64, I64]
        lib.aggregate.restype = _i64
        lib.split_pattern.argtypes = [_i64, _i64] + [I64] * 6
        lib.split_pattern.restype = _i64
        lib.stencil_csr.argtypes = [_i64, I64, _i64, I64, F64, I64, I64,
                                    I64, F64]
        lib.stencil_csr.restype = _i64
        lib.finalize_interp.argtypes = [_i64, _i64, I64, I64, F64, I64,
                                        _i64, I64]
        lib.greedy_coloring.argtypes = [_i64, I64, I64, I64]
        lib.greedy_coloring.restype = _i64
        lib.level_schedule.argtypes = [_i64, I64, I64, _i64, I64]
        lib.interp_dev_widths.argtypes = [_i64, I64, I64, F64, I8, I64, I64]
        lib.interp_dev_pack.argtypes = (
            [_i64, I64, I64, F64, I8, I64]
            + [_i64, I32, F64]                  # sc
            + [_i64, I32, F64, F64, F64]        # sf + di + at
            + [_i64, I32, F64] * 3              # bcs, bcw, awc
            + [F64, F64])                       # dsc, wsum0
        lib.interp_dev_widths_mc.argtypes = [_i64, I64, I64, I8, I64, I64]
        lib.interp_dev_pack_mc.argtypes = (
            [_i64, I64, I64, F64, I8, I64, I64, _i64]
            + [_i64, I32, F64] * 3              # sc, sf, ba
            + [F64, F64])                       # wsum0, sgn
        for fn in (lib.rs_first_pass, lib.rs_second_pass,
                   lib.cljp_main_loop, lib.pmis_main_loop, lib.mark_strong,
                   lib.glibc_rand_doubles, lib.spgemm_fetch,
                   lib.finalize_interp, lib.level_schedule, lib.mis2,
                   lib.dist_cljp_update, lib.dist_mis2_step1,
                   lib.dist_mis2_step2, lib.dist_mis2_steps34,
                   lib.dist_aggregate_pass1, lib.dist_aggregate_pass2,
                   lib.interp_dev_widths, lib.interp_dev_pack,
                   lib.interp_dev_widths_mc, lib.interp_dev_pack_mc):
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


def _variables(variables, num_variables):
    """The (variables, num_variables) pair a kernel takes: the per-row
    variable ids of unknown-based (systems) AMG, or a one-entry dummy and
    1 when ``variables`` is None or ``num_variables`` is 1 (the kernels
    then read no id)."""
    if variables is None or num_variables == 1:
        return np.zeros(1, dtype=np.int64), 1
    return _c(variables), int(num_variables)


def _interp(fn, a_indptr, a_indices, a_data, strong, states, bound,
            variables=None, num_variables=1):
    """Run one interpolation kernel into triplet buffers of ``bound``
    entries; returns the row-ordered (rows, cols, vals). With
    ``variables`` the weak sums count same-variable entries only."""
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    a_data = _f(a_data)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    variables, num_variables = _variables(variables, num_variables)
    rows = np.empty(bound, dtype=np.int64)
    cols = np.empty(bound, dtype=np.int64)
    vals = np.empty(bound, dtype=np.float64)
    nnz = fn(len(a_indptr) - 1, _p(a_indptr, I64), _p(a_indices, I64),
             _p(a_data, F64), _p(strong, I8), _p(states, I64),
             _p(variables, I64), num_variables, _p(rows, I64),
             _p(cols, I64), _p(vals, F64))
    return rows[:nnz], cols[:nnz], vals[:nnz]


def mod_classical_interp(a_indptr, a_indices, a_data, strong, states,
                         variables=None, num_variables: int = 1):
    """Row-ordered (rows, cols, vals) triplets of modified-classical P
    (par_interpolation.cpp:1012-1400), unknown-based with ``variables``."""
    return _interp(load().mod_classical_interp, a_indptr, a_indices, a_data,
                   strong, states, len(a_indices) + len(a_indptr),
                   variables, num_variables)


def extended_interp(a_indptr, a_indices, a_data, strong, states, bound,
                    variables=None, num_variables: int = 1):
    """Row-ordered (rows, cols, vals) triplets of extended+i P with the
    production semantics (par_interpolation.cpp:301-1010), unknown-based
    with ``variables``; columns come unsorted within a row. ``bound`` is
    ``interp_pattern_bound`` of the same inputs."""
    return _interp(load().extended_interp, a_indptr, a_indices, a_data,
                   strong, states, bound, variables, num_variables)


def interp_pattern_bound(a_indptr, a_indices, strong, states) -> int:
    """Entry-count bound of the extended+i distance-2 pattern (one C pass
    over A's entries; ``strong`` int8, ``states`` CF states). It reads no
    variables: the pattern is the strong graph's whatever the weak sums
    count, so the bound holds for systems AMG too, as in the JAX
    package."""
    lib = load()
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    return int(lib.interp_pattern_bound(
        len(a_indptr) - 1, _p(a_indptr, I64), _p(a_indices, I64),
        _p(strong, I8), _p(states, I64)))


def _ell_out(w, n):
    """An ELL operand the native packer fills: [w, n] int32 columns and
    [w, n] float64 values."""
    return (np.empty((w, n), dtype=np.int32),
            np.empty((w, n), dtype=np.float64))


def interp_dev_prep(a_indptr, a_indices, a_data, strong, states):
    """Every host operand of the device extended+i engine in one pass over
    the sorted CSR (``device.interp._prep``'s contract): a dict of the ELL
    pairs ``sc``, ``sf``, ``bcs``, ``bcw``, ``awc`` ([W, n] int32 columns,
    SENT-padded, and float64 values), ``di_v`` and ``at_v`` (aligned with
    ``sf``), the row vectors ``dsc`` and ``wsum0``, and ``p_bound``."""
    lib = load()
    n = len(a_indptr) - 1
    a_indptr, a_indices, a_data = _c(a_indptr), _c(a_indices), _f(a_data)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    widths = np.zeros(6, dtype=np.int64)
    lib.interp_dev_widths(n, _p(a_indptr, I64), _p(a_indices, I64),
                          _p(a_data, F64), _p(strong, I8),
                          _p(states, I64), _p(widths, I64))
    w_sc, w_sf, w_bcs, w_bcw, w_awc, p_bound = (int(x) for x in widths)
    sc_c, sc_v = _ell_out(w_sc, n)
    sf_c, sf_v = _ell_out(w_sf, n)
    di_v = np.empty((w_sf, n))
    at_v = np.empty((w_sf, n))
    bcs_c, bcs_v = _ell_out(w_bcs, n)
    bcw_c, bcw_v = _ell_out(w_bcw, n)
    awc_c, awc_v = _ell_out(w_awc, n)
    dsc = np.empty(n)
    wsum0 = np.empty(n)
    lib.interp_dev_pack(
        n, _p(a_indptr, I64), _p(a_indices, I64), _p(a_data, F64),
        _p(strong, I8), _p(states, I64),
        w_sc, _p(sc_c, I32), _p(sc_v, F64),
        w_sf, _p(sf_c, I32), _p(sf_v, F64), _p(di_v, F64), _p(at_v, F64),
        w_bcs, _p(bcs_c, I32), _p(bcs_v, F64),
        w_bcw, _p(bcw_c, I32), _p(bcw_v, F64),
        w_awc, _p(awc_c, I32), _p(awc_v, F64),
        _p(dsc, F64), _p(wsum0, F64))
    return dict(sc=(sc_c, sc_v), sf=(sf_c, sf_v), di_v=di_v, at_v=at_v,
                bcs=(bcs_c, bcs_v), bcw=(bcw_c, bcw_v),
                awc=(awc_c, awc_v), dsc=dsc, wsum0=wsum0, p_bound=p_bound)


def interp_dev_prep_mc(a_indptr, a_indices, a_data, strong, states,
                       variables=None, num_variables: int = 1):
    """The modified-classical counterpart of ``interp_dev_prep``: the ELL
    pairs ``sc``, ``sf`` and ``ba`` (every C-state off-diagonal entry; the
    sign test against each target row runs on the device), ``wsum0`` with
    same-variable weak sums, and ``sgn``, the sign of each diagonal."""
    lib = load()
    n = len(a_indptr) - 1
    a_indptr, a_indices, a_data = _c(a_indptr), _c(a_indices), _f(a_data)
    strong = np.ascontiguousarray(strong, dtype=np.int8)
    states = _c(states)
    variables, num_variables = _variables(variables, num_variables)
    widths = np.zeros(3, dtype=np.int64)
    lib.interp_dev_widths_mc(n, _p(a_indptr, I64), _p(a_indices, I64),
                             _p(strong, I8), _p(states, I64),
                             _p(widths, I64))
    w_sc, w_sf, w_ba = (int(x) for x in widths)
    sc_c, sc_v = _ell_out(w_sc, n)
    sf_c, sf_v = _ell_out(w_sf, n)
    ba_c, ba_v = _ell_out(w_ba, n)
    wsum0 = np.empty(n)
    sgn = np.empty(n)
    lib.interp_dev_pack_mc(
        n, _p(a_indptr, I64), _p(a_indices, I64), _p(a_data, F64),
        _p(strong, I8), _p(states, I64), _p(variables, I64),
        int(num_variables),
        w_sc, _p(sc_c, I32), _p(sc_v, F64),
        w_sf, _p(sf_c, I32), _p(sf_v, F64),
        w_ba, _p(ba_c, I32), _p(ba_v, F64),
        _p(wsum0, F64), _p(sgn, F64))
    return dict(sc=(sc_c, sc_v), sf=(sf_c, sf_v), ba=(ba_c, ba_v),
                wsum0=wsum0, sgn=sgn)


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


def greedy_coloring(indptr, indices) -> np.ndarray:
    """Greedy colouring in row order (smallest colour no coloured
    neighbour holds) of a symmetric CSR pattern: int64 colours."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    n = len(indptr) - 1
    colors = np.full(n, -1, dtype=np.int64)
    lib.greedy_coloring(n, _p(indptr, I64), _p(indices, I64),
                        _p(colors, I64))
    return colors


def level_schedule(indptr, indices, reverse: bool) -> np.ndarray:
    """Dependency level of each row of a strictly triangular CSR block:
    1 + the highest level among its columns, 0 for an empty row; rows
    ascending (lower triangle) or, with ``reverse``, descending (upper)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    n = len(indptr) - 1
    level = np.zeros(n, dtype=np.int64)
    lib.level_schedule(n, _p(indptr, I64), _p(indices, I64),
                       int(reverse), _p(level, I64))
    return level


def glibc_rand_doubles(seed: int, n: int) -> np.ndarray:
    lib = load()
    out = np.empty(n, dtype=np.float64)
    lib.glibc_rand_doubles(seed, n, _p(out, F64))
    return out


def classical_strength_csr(indptr, indices, data, theta, variables=None,
                           num_variables: int = 1):
    """Classical strength S as a CSR (threshold + compress in one pass);
    with ``variables`` (systems AMG) only same-variable off-diagonals set
    a row's scale and can be strong."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    data = _f(data)
    n = len(indptr) - 1
    variables, num_variables = _variables(variables, num_variables)
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(len(indices), dtype=np.int64)
    out_data = np.empty(len(indices))
    m = lib.classical_strength_csr(
        n, _p(indptr, I64), _p(indices, I64), _p(data, F64), float(theta),
        _p(variables, I64), int(num_variables), _p(out_indptr, I64),
        _p(out_indices, I64), _p(out_data, F64))
    return out_indptr, out_indices[:m], out_data[:m]


def symmetric_strength_csr(indptr, indices, data, theta):
    """Symmetric (smoothed-aggregation) strength S as a CSR: an
    off-diagonal entry is kept when it is strong by its row's threshold or
    by its column's (threshold + compress in one pass)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    data = _f(data)
    n = len(indptr) - 1
    out_indptr = np.empty(n + 1, dtype=np.int64)
    out_indices = np.empty(len(indices), dtype=np.int64)
    out_data = np.empty(len(indices))
    m = lib.symmetric_strength_csr(
        n, _p(indptr, I64), _p(indices, I64), _p(data, F64), float(theta),
        _p(out_indptr, I64), _p(out_indices, I64), _p(out_data, F64))
    return out_indptr, out_indices[:m], out_data[:m]


def _check_out(a, n, name, dtype=np.int64):
    """An array the native code writes in place: contiguous ``dtype`` of
    n entries (a converted copy would leave the caller's array as it
    was)."""
    if not (isinstance(a, np.ndarray) and a.dtype == dtype
            and a.flags.c_contiguous and a.shape == (n,)):
        raise ValueError(f"{name} must be a contiguous {np.dtype(dtype)} "
                         f"array of {n} entries")


def mis2(indptr, indices, cindptr, cindices, r, states):
    """Distance-2 maximal independent set (aggregation/mis.cpp:8-220) of a
    sorted CSR pattern with its diagonal and its sorted CSC, ranked by the
    float64 weights ``r``; in place on ``states`` (contiguous int64)."""
    lib = load()
    n = len(indptr) - 1
    _check_out(states, n, "states")
    indptr, indices = _c(indptr), _c(indices)
    cindptr, cindices = _c(cindptr), _c(cindices)
    r = _f(r)
    if len(r) < n or len(cindptr) != n + 1:
        raise ValueError("mis2: weights or CSC shorter than the matrix")
    lib.mis2(n, _p(indptr, I64), _p(indices, I64),
             _p(cindptr, I64), _p(cindices, I64), _p(r, F64),
             _p(states, I64))


def dist_cljp_update(n, h, first_local_col, on_indptr, on_indices,
                     off_indptr, off_indices, hp_indptr, hp_cols, cmap,
                     st, hstU, sel, hnew, edgemark_on, edgemark_off,
                     w, off_dec):
    """One round of the distributed CLJP weight updates
    (par_cf_splitting.cpp:590-708) on one shard of ``n`` rows and ``h``
    halo columns: in place on ``edgemark_on`` / ``edgemark_off``
    (contiguous int64, one per entry of the on / off pattern), ``w``
    (contiguous float64 of n) and ``off_dec`` (contiguous float64 of h).
    ``hp_*`` are the prefetched halo S row patterns in global columns,
    ``cmap`` the shard's off_proc column map."""
    lib = load()
    on_indptr, off_indptr = _c(on_indptr), _c(off_indptr)
    if len(on_indptr) != n + 1 or len(off_indptr) != n + 1:
        raise ValueError("dist_cljp_update: patterns do not have n rows")
    _check_out(edgemark_on, int(on_indptr[-1]), "edgemark_on")
    _check_out(edgemark_off, int(off_indptr[-1]), "edgemark_off")
    _check_out(w, n, "w", np.float64)
    _check_out(off_dec, h, "off_dec", np.float64)
    args = [on_indptr, _c(on_indices), off_indptr, _c(off_indices),
            _c(hp_indptr), _c(hp_cols), _c(cmap), _c(st), _c(hstU),
            _c(sel), _c(hnew)]
    # hp_indptr, cmap, st, hstU, sel, hnew
    if [len(a) for a in args[4:5] + args[6:]] != [h + 1, h, n, h, n, h]:
        raise ValueError("dist_cljp_update: halo or state arrays do not "
                         "match n and h")
    lib.dist_cljp_update(
        n, h, first_local_col, *[_p(a, I64) for a in args],
        _p(edgemark_on, I64), _p(edgemark_off, I64), _p(w, F64),
        _p(off_dec, F64))


def _pattern_rows(what, n, *indptrs):
    """The CSR row pointers ``indptrs`` as contiguous int64, each of n + 1
    entries."""
    out = [_c(p) for p in indptrs]
    if any(len(p) != n + 1 for p in out):
        raise ValueError(f"{what}: a pattern does not have {n} rows")
    return out


def _halo_lookup(what, h, hp_indptr, hp_cols, fr, fst):
    """The prefetched halo S row patterns (``h`` rows, global columns) and
    the sorted fringe ids with their states, checked and contiguous."""
    hp_indptr, hp_cols, fr, fst = (_c(hp_indptr), _c(hp_cols), _c(fr),
                                   _c(fst))
    if len(hp_indptr) != h + 1 or len(fst) != len(fr):
        raise ValueError(f"{what}: halo patterns or fringe arrays do not "
                         f"match h = {h}")
    return hp_indptr, hp_cols, fr, fst


def dist_mis2_step1(on_indptr, on_indices, off_indptr, off_indices, rr,
                    halo_r, hst, st):
    """Step 1 of a distributed MIS(2) round (aggregation/par_mis.cpp:
    216-655) on one shard: an Unassigned row with no larger-weighted
    Unassigned or beyond-Selected neighbour, on or off the shard, becomes
    TmpSelection. In place on ``st`` (contiguous int64 of n)."""
    lib = load()
    n = len(st)
    _check_out(st, n, "st")
    on_indptr, off_indptr = _pattern_rows("dist_mis2_step1", n, on_indptr,
                                          off_indptr)
    hst = _c(hst)
    rr, halo_r = _f(rr), _f(halo_r)
    if len(rr) != n or len(halo_r) != len(hst):
        raise ValueError("dist_mis2_step1: weights do not match the rows "
                         "or the halo")
    lib.dist_mis2_step1(n, _p(on_indptr, I64), _p(_c(on_indices), I64),
                        _p(off_indptr, I64), _p(_c(off_indices), I64),
                        _p(rr, F64), _p(halo_r, F64), _p(hst, I64),
                        _p(st, I64))


def dist_mis2_step2(h, on_indptr, on_indices, off_indptr, off_indices,
                    hp_indptr, hp_cols, rr, halo_r, hst, fr, fst, frr, st):
    """Step 2 (the distance-2 competition) of a distributed MIS(2) round:
    a TmpSelection row stays one unless a row two steps away, on the
    shard, in its halo or in the fringe (``fr`` sorted global ids with
    states ``fst`` and weights ``frr``), is beyond Selected with a larger
    weight; the survivors become NewSelection. In place on ``st``."""
    lib = load()
    n = len(st)
    _check_out(st, n, "st")
    on_indptr, off_indptr = _pattern_rows("dist_mis2_step2", n, on_indptr,
                                          off_indptr)
    hp_indptr, hp_cols, fr, fst = _halo_lookup("dist_mis2_step2", h,
                                               hp_indptr, hp_cols, fr, fst)
    hst = _c(hst)
    rr, halo_r, frr = _f(rr), _f(halo_r), _f(frr)
    if (len(rr) != n or len(halo_r) != h or len(hst) != h
            or len(frr) != len(fr)):
        raise ValueError("dist_mis2_step2: weights or states do not match "
                         "n, h or the fringe")
    lib.dist_mis2_step2(n, h, _p(on_indptr, I64), _p(_c(on_indices), I64),
                        _p(off_indptr, I64), _p(_c(off_indices), I64),
                        _p(hp_indptr, I64), _p(hp_cols, I64), _p(rr, F64),
                        _p(halo_r, F64), _p(hst, I64), _p(fr, I64),
                        len(fr), _p(fst, I64), _p(frr, F64), _p(st, I64))


def dist_mis2_steps34(h, on_indptr, on_indices, off_indptr, off_indices,
                      hp_indptr, hp_cols, hst, fr, fst, st):
    """Steps 3 and 4 of a distributed MIS(2) round: an Unassigned or
    TmpSelection row next to a NewSelection, or to a row (on the shard or
    in its halo) next to one, becomes NewUnselection. In place on
    ``st``."""
    lib = load()
    n = len(st)
    _check_out(st, n, "st")
    on_indptr, off_indptr = _pattern_rows("dist_mis2_steps34", n,
                                          on_indptr, off_indptr)
    hp_indptr, hp_cols, fr, fst = _halo_lookup("dist_mis2_steps34", h,
                                               hp_indptr, hp_cols, fr, fst)
    hst = _c(hst)
    if len(hst) != h:
        raise ValueError("dist_mis2_steps34: halo states do not match h")
    lib.dist_mis2_steps34(n, h, _p(on_indptr, I64),
                          _p(_c(on_indices), I64), _p(off_indptr, I64),
                          _p(_c(off_indices), I64), _p(hp_indptr, I64),
                          _p(hp_cols, I64), _p(hst, I64), _p(fr, I64),
                          len(fr), _p(fst, I64), _p(st, I64))


def dist_aggregate_pass1(first_local_col, s_on_indptr, s_on_indices,
                         s_off_indptr, s_off_indices, cmap, st, hst, hagg,
                         agg):
    """Pass 1 of the distributed aggregation (aggregation/
    par_aggregate.cpp:7-187) on one shard: a row that is no root joins the
    aggregate of its first root neighbour in global column order, on the
    shard (``agg``) or in its halo (``hst`` / ``hagg``). In place on
    ``agg`` (contiguous int64 of n)."""
    lib = load()
    n = len(agg)
    _check_out(agg, n, "agg")
    s_on_indptr, s_off_indptr = _pattern_rows(
        "dist_aggregate_pass1", n, s_on_indptr, s_off_indptr)
    cmap, st, hst, hagg = _c(cmap), _c(st), _c(hst), _c(hagg)
    if len(st) != n or not len(cmap) == len(hst) == len(hagg):
        raise ValueError("dist_aggregate_pass1: states or halo arrays do "
                         "not match the shard")
    lib.dist_aggregate_pass1(
        n, first_local_col, _p(s_on_indptr, I64), _p(_c(s_on_indices), I64),
        _p(s_off_indptr, I64), _p(_c(s_off_indices), I64), _p(cmap, I64),
        _p(st, I64), _p(hst, I64), _p(hagg, I64), _p(agg, I64))


def dist_aggregate_pass2(s_on_indptr, s_on_indices, s_off_indptr,
                         s_off_indices, a_on_indptr, a_on_indices,
                         a_on_data, a_off_indptr, a_off_indices, a_off_data,
                         amap, smap, r_loc, halo_r, hagg, agg):
    """Pass 2 of the distributed aggregation: a row still unassigned
    takes the aggregate of its strongest assigned neighbour (|a_ij| plus
    the neighbour's weight), encoded as -(aggregate + 1) so the pass does
    not cascade; the caller decodes. In place on ``agg``."""
    lib = load()
    n = len(agg)
    _check_out(agg, n, "agg")
    s_on_indptr, s_off_indptr, a_on_indptr, a_off_indptr = _pattern_rows(
        "dist_aggregate_pass2", n, s_on_indptr, s_off_indptr, a_on_indptr,
        a_off_indptr)
    amap, smap, hagg = _c(amap), _c(smap), _c(hagg)
    r_loc, halo_r = _f(r_loc), _f(halo_r)
    if len(r_loc) != n or not len(smap) == len(halo_r) == len(hagg):
        raise ValueError("dist_aggregate_pass2: weights or halo arrays do "
                         "not match the shard")
    lib.dist_aggregate_pass2(
        n, _p(s_on_indptr, I64), _p(_c(s_on_indices), I64),
        _p(s_off_indptr, I64), _p(_c(s_off_indices), I64),
        _p(a_on_indptr, I64), _p(_c(a_on_indices), I64),
        _p(_f(a_on_data), F64), _p(a_off_indptr, I64),
        _p(_c(a_off_indices), I64), _p(_f(a_off_data), F64),
        _p(amap, I64), _p(smap, I64), _p(r_loc, F64), _p(halo_r, F64),
        _p(hagg, I64), _p(agg, I64))


def aggregate(s_indptr, s_indices, a_indptr, a_indices, a_data, states, r,
              aggregates) -> int:
    """Aggregation around the MIS(2) roots (aggregation/aggregate.cpp:
    6-95) over sorted S and A; writes ``aggregates`` (contiguous int64) in
    place and returns the number of aggregates."""
    lib = load()
    n = len(s_indptr) - 1
    _check_out(aggregates, n, "aggregates")
    s_indptr, s_indices = _c(s_indptr), _c(s_indices)
    a_indptr, a_indices = _c(a_indptr), _c(a_indices)
    a_data, states, r = _f(a_data), _c(states), _f(r)
    if len(states) != n or len(r) < n or len(a_indptr) != n + 1:
        raise ValueError("aggregate: states, weights or A do not match S")
    return int(lib.aggregate(
        n, _p(s_indptr, I64), _p(s_indices, I64),
        _p(a_indptr, I64), _p(a_indices, I64), _p(a_data, F64),
        _p(states, I64), _p(r, F64), _p(aggregates, I64)))


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


def partition_kway(indptr, indices, ew, n, k):
    """Multilevel k-way partition of a symmetric adjacency CSR without
    self loops (the ParMETIS_V3_PartKway analog): heavy-edge matching,
    greedy growing, boundary FM refinement, with edge weights ``ew``
    (None: 1). Returns (part[n], edge_cut)."""
    lib = load()
    indptr, indices = _c(indptr), _c(indices)
    part = np.zeros(n, dtype=np.int64)
    if ew is not None:
        ew = _f(ew)
        ew_p = _p(ew, F64)
    else:
        ew_p = F64()
    cut = lib.partition_kway(n, _p(indptr, I64), _p(indices, I64), ew_p, k,
                             _p(part, I64))
    # the C side returns the cut in units of 2^-20
    return part, cut / 1048576.0
