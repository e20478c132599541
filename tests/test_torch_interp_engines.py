"""Parity of the port's device interpolation engines (raptor_tpu_torch.
device.interp) with the JAX package's (raptor_tpu.device.interp) and with
the native host kernels, and the dispatch between the engines.

Both device engines run in float64 on the CPU here: each P must have the
JAX function's and the host kernel's structure exactly and their values to
1e-12 (the cases of tests/test_device_interp.py). A hierarchy built with
the device extended+i is held by a per-level replay, not as a whole: value
differences of 1e-16 flip ties of ``filter_interp`` further down, which
changes the next level's operator without any engine being wrong.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu import native as jnative  # noqa: E402
from raptor_tpu.core.matrix import CSRMatrix as JCSR  # noqa: E402
from raptor_tpu.core.par_matrix import ParCSRMatrix as JPar  # noqa: E402
from raptor_tpu.core.partition import Partition as JPart  # noqa: E402
from raptor_tpu.core.types import StrengthType as JStrength  # noqa: E402
from raptor_tpu.device import interp as jdi  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben import interpolation as jint  # noqa: E402
from raptor_tpu.ruge_stuben.strength import strength as jstrength  # noqa
from raptor_tpu.utils.glibc_rand import form_rand_weights  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, StrengthType)
from raptor_tpu_torch.device import interp as tdi  # noqa: E402
from raptor_tpu_torch.device import spgemm as tsp  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.ruge_stuben import cf_splitting as tcf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import interpolation as tint  # noqa: E402
from raptor_tpu_torch.ruge_stuben.strength import strength  # noqa: E402

from _torch_parity import to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

ANISO = (0.001, np.pi / 8)


def _port(m) -> TCSR:
    return TCSR(m.n_rows, m.n_cols, m.indptr.copy(), m.indices.copy(),
                np.asarray(m.data, np.float64).copy())


def _same(got, ref, tol=1e-12):
    """Equal structure; values within tol of max |ref|."""
    assert (got.n_rows, got.n_cols) == (ref.n_rows, ref.n_cols)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    scale = max(1.0, float(np.abs(ref.data).max()) if ref.nnz else 1.0)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=tol * scale)


def _random_operator():
    """An unstructured, non-symmetric operator: missing a_ki transposes,
    tiny denominators, rows without strong C points, NoNeighbors rows."""
    n = 160
    m = sp.random(n, n, density=0.05, random_state=3, format="csr")
    m = (m + m.T.multiply(0.3)).tocsr()
    m.setdiag(np.abs(m).sum(axis=1).A1 + 0.5)
    m.sort_indices()
    return JPar(JCSR.from_scipy(m.tocsr()), JPart.create(n, n, 1))


# name: (operator, JAX splitting, theta)
CASES = {
    "aniso24_pmis": (lambda: jst.par_stencil_grid(
        jst.diffusion_stencil_2d(*ANISO), (24, 24), 1), jcf.split_pmis,
        0.25),
    "aniso24_hmis": (lambda: jst.par_stencil_grid(
        jst.diffusion_stencil_2d(*ANISO), (24, 24), 1), jcf.split_hmis,
        0.25),
    "lap16_pmis": (lambda: jst.par_stencil_grid(
        jst.laplace_stencil_27pt(), (16, 16, 16), 1), jcf.split_pmis, 0.25),
    "mild20_cljp": (lambda: jst.par_stencil_grid(
        jst.diffusion_stencil_2d(0.4, 0.0), (20, 20), 1), jcf.split_cljp,
        0.25),
    "random160_pmis": (_random_operator, jcf.split_pmis, 0.5),
}


def _inputs(case, variables=None, num_variables=1):
    """(A, S, CF states) from the JAX package and the engines' operands:
    A's strong flags and the coarse map."""
    make, split, theta = CASES[case]
    A = make()
    s = jstrength(A, JStrength.Classical, theta, num_variables, variables)
    states = np.asarray(split(s, form_rand_weights(A.global_num_rows, 0)))
    a = A.global_csr
    a_indptr, a_indices, _ = a.sorted_csr()
    s_indptr, s_indices, _ = s.global_csr.sorted_csr()
    strong = jnative.mark_strong(a_indptr, a_indices, s_indptr, s_indices,
                                 a.n_rows)
    col_to_new, n_coarse = jint._coarse_map(states)
    return A, s, states, strong, col_to_new, n_coarse


@pytest.mark.parametrize("case", sorted(CASES))
def test_extended_device_matches_jax_and_host(case):
    A, s, states, strong, col_to_new, n_coarse = _inputs(case)
    a = A.global_csr
    got = tdi.extended_interp_device(_port(a), strong, states, col_to_new,
                                     n_coarse, device="cpu")
    _same(got, jdi.extended_interp_device(a, strong, states, col_to_new,
                                          n_coarse))
    _same(got, jint.extended_interpolation(a, s.global_csr, states))
    # and the port's own host kernel, on the port's containers
    _same(got, tint.extended_interpolation(_port(a), _port(s.global_csr),
                                           states))


@pytest.mark.parametrize("case", sorted(CASES))
def test_prep_native_matches_numpy_oracle_and_jax(case):
    """The native operand pass against its numpy oracle and JAX's pass."""
    A, _, states, strong, _, _ = _inputs(case)
    a = _port(A.global_csr)
    nat = tdi._prep(a, strong, states)
    ora = tdi._prep_numpy(a, strong, states)
    jax_ops = jdi._prep(A.global_csr, strong, states, np.float64)
    for key in nat:
        for ref in (ora, jax_ops):
            want, got = ref[key], nat[key]
            if isinstance(got, tuple):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_allclose(got[1], want[1], rtol=1e-15,
                                           atol=1e-15)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-14,
                                           atol=1e-14)


@pytest.mark.parametrize("case,num_variables",
                         [("aniso24_pmis", 1), ("lap16_pmis", 1),
                          ("mild20_cljp", 1), ("aniso24_pmis", 2),
                          ("mild20_cljp", 3)])
def test_mod_classical_device_matches_jax_and_host(case, num_variables):
    n = CASES[case][0]().global_num_rows
    variables = (None if num_variables == 1 else
                 (np.arange(n) % num_variables).astype(np.int64))
    A, s, states, strong, col_to_new, n_coarse = _inputs(
        case, variables, num_variables)
    a = A.global_csr
    got = tdi.mod_classical_interp_device(
        _port(a), strong, states, col_to_new, n_coarse, variables,
        num_variables, device="cpu")
    _same(got, jdi.mod_classical_interp_device(
        a, strong, states, col_to_new, n_coarse, variables, num_variables))
    _same(got, jint.mod_classical_interpolation(
        a, s.global_csr, states, num_variables, variables))
    if num_variables == 1:
        _same(got, tint.mod_classical_interpolation(
            _port(a), _port(s.global_csr), states))


def test_float32_within_single_precision():
    A, s, states, strong, col_to_new, n_coarse = _inputs("lap16_pmis")
    a = _port(A.global_csr)
    p64 = tdi.extended_interp_device(a, strong, states, col_to_new,
                                     n_coarse, device="cpu")
    p32 = tdi.extended_interp_device(a, strong, states, col_to_new,
                                     n_coarse, dtype=np.float32,
                                     device="cpu")
    np.testing.assert_array_equal(p32.indices, p64.indices)
    assert np.abs(p32.data - p64.data).max() < 1e-5 * np.abs(p64.data).max()


# --- per-level replay on a hierarchy built by the device engines ---------------

def test_per_level_replay_16cubed():
    """The port's 16^3 PMIS + extended+i setup with both engines on the
    device (CPU tensors): on every level, the device P equals the host
    kernel's and JAX's device engine's on the same A, S and CF states, and
    the coarse operator equals the host Galerkin product of (A, P)."""
    from raptor_tpu.device import spgemm as jsp
    A = tst.par_stencil_grid(tst.laplace_stencil_27pt(), (16, 16, 16), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended)
    ml.interp_mode = ml.rap_mode = "device"
    ml.device = "cpu"
    ml.setup(A)
    assert ml.num_levels >= 3
    for i, lvl in enumerate(ml.levels[:-1]):
        assert ml.level_engines[i] == {"interp": "device", "rap": "device"}
        a = lvl.A.global_csr
        s = strength(lvl.A, StrengthType.Classical, 0.25)
        states = tcf.split_pmis(s, ml.weights[:a.n_rows])
        strong, col_to_new, n_coarse = tint._device_interp_inputs(
            a, s.global_csr, states)
        pd = tdi.extended_interp_device(a, strong, states, col_to_new,
                                        n_coarse, device="cpu")
        _same(pd, tint.extended_interpolation(a, s.global_csr, states))
        ja = JCSR(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)
        _same(pd, jdi.extended_interp_device(ja, strong, states, col_to_new,
                                             n_coarse))
        p = lvl.P.global_csr
        _same(ml.levels[i + 1].A.global_csr, p.T_multiply(a.multiply(p)))
        jp = JCSR(p.n_rows, p.n_cols, p.indptr, p.indices, p.data)
        _same(ml.levels[i + 1].A.global_csr, jsp.rap_device(ja, jp)[1])


# --- the dispatch ---------------------------------------------------------------

def _aniso_setup(n=24, interp=InterpType.ModClassical, device="cpu",
                 mode="auto"):
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, interp)
    ml.interp_mode = ml.rap_mode = mode
    ml.device = device
    ml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                                  1))
    return ml


def test_defaults_are_auto_on_cuda():
    ml = ParRugeStubenSolver()
    assert (ml.rap_mode, ml.interp_mode, ml.device) == ("auto", "auto",
                                                        "cuda")
    assert tint.DEVICE_MIN_NNZ == 2_000_000


@pytest.mark.parametrize("interp", [InterpType.ModClassical,
                                    InterpType.Extended])
def test_auto_on_cpu_picks_host(monkeypatch, interp):
    """"auto" with device="cpu" runs the host engines, even on levels past
    the gate (lowered here so that the levels pass it)."""
    monkeypatch.setattr(tint, "DEVICE_MIN_NNZ", 1)

    def boom(*args, **kwargs):
        raise AssertionError("a device engine ran")
    monkeypatch.setattr(tdi, "extended_interp_device", boom)
    monkeypatch.setattr(tdi, "mod_classical_interp_device", boom)
    monkeypatch.setattr(tsp, "rap_device", boom)
    ml = _aniso_setup(interp=interp)
    assert ml.level_engines and all(
        e == {"interp": "host", "rap": "host"} for e in ml.level_engines)
    assert ml.rap_engine_used == "host"


def test_auto_without_a_card_picks_host(monkeypatch):
    """"auto" with device="cuda" where no card is present stays on the
    host, as the JAX package's "auto" does off its chip."""
    monkeypatch.setattr(tint, "DEVICE_MIN_NNZ", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ml = _aniso_setup(device="cuda")
    assert all(e == {"interp": "host", "rap": "host"}
               for e in ml.level_engines)


def test_auto_past_the_gate_picks_device(monkeypatch):
    """"auto" with a present card runs the device engines on the levels
    at or above the gate and the host below it (the card stood in for by
    the CPU here)."""
    ml0 = _aniso_setup(mode="host")
    gate = ml0.levels[1].A.nnz
    monkeypatch.setattr(tint, "DEVICE_MIN_NNZ", gate)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for mod in (tdi, tsp):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda d: torch.device("cpu"))
    ml = _aniso_setup(device="cuda")
    for lvl, e in zip(ml.levels, ml.level_engines):
        want = "device" if lvl.A.nnz >= gate else "host"
        assert e == {"interp": want, "rap": want}
    assert {e["rap"] for e in ml.level_engines} == {"device", "host"}


@pytest.mark.parametrize("step", ["interp", "rap"])
def test_device_mode_on_cuda_raises_without_a_card(step):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical)
    setattr(ml, f"{step}_mode", "device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO),
                                      (16, 16), 1))


@pytest.mark.parametrize("target", ["extended_interp_device",
                                    "mod_classical_interp_device",
                                    "rap_device"])
def test_device_engine_error_propagates(monkeypatch, target):
    """A failure inside a device engine reaches the caller. The JAX
    package catches every exception of its device engines and runs the
    host kernel with a warning (its test_device_failure_falls_back_to_host),
    which there covers a remote compiler that can fail; here an engine's
    error is a fault to see, not an engine choice to hide."""
    def boom(*args, **kwargs):
        raise RuntimeError("synthetic device failure")
    monkeypatch.setattr(tsp if target == "rap_device" else tdi, target,
                        boom)
    interp = (InterpType.Extended if target == "extended_interp_device"
              else InterpType.ModClassical)
    with pytest.raises(RuntimeError, match="synthetic device failure"):
        _aniso_setup(16, interp, mode="device")


def test_interp_cap_routes_to_host_and_is_recorded(monkeypatch):
    def overflow(*args, **kwargs):
        raise tdi.InterpOverflow("pattern width 9 > cap 8")
    monkeypatch.setattr(tdi, "extended_interp_device", overflow)
    ml = _aniso_setup(16, InterpType.Extended, mode="device")
    ref = _aniso_setup(16, InterpType.Extended, mode="host")
    for e in ml.level_engines:
        assert e["interp"] == "host" and e["rap"] == "device"
        assert e["interp_reason"] == "cap: pattern width 9 > cap 8"
    assert tint.LAST_ENGINE["interp"] == "host"
    _same(ml.levels[0].P.global_csr, ref.levels[0].P.global_csr)


def test_rap_cap_routes_to_host_and_is_recorded(monkeypatch):
    def overflow(*args, **kwargs):
        raise tsp.CapOverflow("row width 99 > cap 98")
    monkeypatch.setattr(tsp, "rap_device", overflow)
    ml = _aniso_setup(16, mode="device")
    assert ml.rap_engine_used == "host"
    for e in ml.level_engines:
        assert e == {"interp": "device", "rap": "host",
                     "rap_reason": "cap: row width 99 > cap 98"}


def test_last_engine_counts_device_runs():
    before = tint.LAST_ENGINE["device_calls"]
    ml = _aniso_setup(16, mode="device")
    assert tint.LAST_ENGINE["interp"] == "device"
    assert (tint.LAST_ENGINE["device_calls"] - before
            == ml.num_levels - 1)


def test_par_interpolation_engines_agree():
    """par_interpolation's engine argument: the device engine's P equals
    the host kernel's, with the same partition."""
    A = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (20, 20), 4)
    tA = to_port(A)
    s = strength(tA, StrengthType.Classical, 0.25)
    states = tcf.split_pmis(s, form_rand_weights(tA.global_num_rows, 0))
    for kind in ("extended", "mod_classical"):
        ph = tint.par_interpolation(tA, s, states, kind, "host")
        pd = tint.par_interpolation(tA, s, states, kind, "device", "cpu")
        _same(pd.global_csr, ph.global_csr)
        np.testing.assert_array_equal(pd.partition.col_bounds,
                                      ph.partition.col_bounds)


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        _aniso_setup(16, mode="gpu")


def test_engines_read_no_environment():
    """The port has no environment switch for its setup engines."""
    import inspect
    from raptor_tpu_torch.multilevel import par_multilevel
    for mod in (tdi, tsp, tint, par_multilevel):
        assert "environ" not in inspect.getsource(mod)
