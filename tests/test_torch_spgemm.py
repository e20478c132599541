"""Parity of the port's device Galerkin engine (raptor_tpu_torch.device.
spgemm) with the JAX package's (raptor_tpu.device.spgemm) and with the
native host SpGEMM.

Both device engines run in float64 on the CPU here: the structure of every
product must be the JAX function's and the host kernel's exactly (the same
sort, merge and zero drop), the values equal to 1e-12 of the largest
(summation order only). The cases are those of tests/test_device_spgemm.py;
whole hierarchies built with ``rap_mode="device"`` are held to JAX's level
by level to 1e-11. The engine on the card is held to the same engine on the
CPU by tests/test_torch_engines_cuda.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.types import CoarsenType as JCoarsen  # noqa: E402
from raptor_tpu.core.types import InterpType as JInterp  # noqa: E402
from raptor_tpu.core.types import RelaxType as JRelax  # noqa: E402
from raptor_tpu.device import spgemm as jsp  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.gallery.random import random_matrix  # noqa: E402
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    ZERO_TOL, CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.device import spgemm as tsp  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import SA_PROBLEMS, sa_matrix  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

SENT = int(tsp.SENT)


def _port(m) -> TCSR:
    """A JAX-package CSRMatrix as the port's, on copies of its arrays."""
    return TCSR(m.n_rows, m.n_cols, m.indptr.copy(), m.indices.copy(),
                np.asarray(m.data, np.float64).copy())


def _same(got, ref, tol=1e-12):
    """Equal structure; values within tol of max |ref|."""
    assert (got.n_rows, got.n_cols) == (ref.n_rows, ref.n_cols)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    scale = max(1.0, float(np.abs(ref.data).max()) if ref.nnz else 1.0)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=tol * scale)


def _aniso(n=36):
    return jst.stencil_grid(jst.diffusion_stencil_2d(0.001, np.pi / 8),
                            (n, n))


# --- the merge of a candidate slab --------------------------------------------

def _slab(seed, H, C, exact):
    """A [H, C] candidate slab: columns in [0, 40) with a share of SENT
    padding; ``exact`` values are small integers, in +v / -v pairs on one
    column where the slab cancels exactly (every sum is exact in float64,
    whatever its order), else standard normal."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 40, (H, C)).astype(np.int32)
    c[rng.random((H, C)) < 0.2] = SENT
    if exact:
        v = rng.integers(-4, 5, (H, C)).astype(np.float64)
        half = H // 2
        c[half:2 * half] = c[:half]
        v[half:2 * half] = -v[:half]
    else:
        v = rng.standard_normal((H, C))
    v[c == SENT] = 0.0
    return c, v


def _merge_host(c, v, w_cap, zero_tol):
    """The merge in plain numpy, column by column: (cols, vals, counts)
    cut to w_cap, SENT / 0 past each count."""
    H, C = c.shape
    cols = np.full((min(H, w_cap), C), SENT, np.int32)
    vals = np.zeros((min(H, w_cap), C))
    counts = np.zeros(C, np.int32)
    for j in range(C):
        acc = {}
        for k, x in zip(c[:, j], v[:, j]):
            if k != SENT:
                acc[k] = acc.get(k, 0.0) + x
        keys = [k for k in sorted(acc) if abs(acc[k]) > zero_tol]
        counts[j] = len(keys)
        keys = keys[:w_cap]
        cols[:len(keys), j] = keys
        vals[:len(keys), j] = [acc[k] for k in keys]
    return cols, vals, counts


# (height, w_cap): flat slabs, and slabs taller than the 1,024-row group
# that merge as a tree
MERGES = [(7, 4), (64, 64), (300, 12), (1500, 40), (2600, 600)]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("H,w_cap", MERGES)
def test_merge_compact_matches_jax_and_host(H, w_cap, exact):
    c, v = _slab(H * 7 + exact, H, 33, exact)
    tc, tv, tn, tm = tsp._merge_compact(torch.from_numpy(c),
                                        torch.from_numpy(v), w_cap, ZERO_TOL)
    jc, jv, jn, jm = jsp._merge_compact(jnp.asarray(c), jnp.asarray(v),
                                        w_cap, ZERO_TOL)
    hc, hv, hn = _merge_host(c, v, w_cap, ZERO_TOL)
    tc, tv, tn = tc.numpy(), tv.numpy(), tn.numpy()
    np.testing.assert_array_equal(tc, np.asarray(jc))
    np.testing.assert_array_equal(tn, np.asarray(jn))
    # no group is cut here, so the port's max is the widest row; JAX's
    # tree also counts its groups, whose partial sums may not cancel yet
    assert int(tm) == hn.max() <= int(jm)
    tol = 0.0 if exact else 1e-12 * np.abs(hv).max()
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=tol)
    # the host merge's columns and counts where no row outgrew w_cap
    ok = hn <= w_cap
    np.testing.assert_array_equal(tc[:, ok], hc[:, ok])
    np.testing.assert_array_equal(tn, hn)
    np.testing.assert_allclose(tv[:, ok], hv[:, ok], rtol=0, atol=tol)


def test_merge_compact_keeps_zero_valued_pattern_entries():
    """A negative drop tolerance keeps every column, exact zeros included,
    in a tree merge too (the interpolation engines merge patterns whose
    distance-2 entries hold 0)."""
    rng = np.random.default_rng(3)
    c = rng.integers(0, 30, (1800, 9)).astype(np.int32)
    v = np.zeros((1800, 9))
    tc, _, tn, _ = tsp._merge_compact(torch.from_numpy(c),
                                      torch.from_numpy(v), 32, -1.0)
    for j in range(9):
        want = np.unique(c[:, j])
        assert tn[j] == len(want)
        np.testing.assert_array_equal(tc[:len(want), j].numpy(), want)


def test_segmented_sum_is_the_recurrence():
    rng = np.random.default_rng(5)
    same = rng.random((50, 6)) < 0.6
    same[0] = False
    v = rng.standard_normal((50, 6))
    want = v.copy()
    for j in range(1, 50):
        want[j] += np.where(same[j], want[j - 1], 0.0)
    got = tsp._segmented_sum(torch.from_numpy(same), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-14)


# --- products -----------------------------------------------------------------

def test_ell_spgemm_random():
    a = random_matrix(300, 300, 6, seed=11)
    b = random_matrix(300, 200, 4, seed=12)
    ta, tb = _port(a), _port(b)
    assert tsp.csr_to_dia(ta) is None
    got = tsp.spgemm_device(ta, tb, device="cpu")
    _same(got, jsp.spgemm_device(a, b))
    _same(got, ta.multiply(tb))


def test_dia_path_stencil():
    A = _aniso()
    b = random_matrix(A.n_cols, 150, 3, seed=5)
    tA, tb = _port(A), _port(b)
    offsets, vals = tsp.csr_to_dia(tA)
    joff, jvals = jsp.csr_to_dia(A)
    np.testing.assert_array_equal(offsets, joff)
    np.testing.assert_array_equal(vals, jvals)
    got = tsp.spgemm_device(tA, tb, device="cpu")
    _same(got, jsp.spgemm_device(A, b))
    _same(got, tA.multiply(tb))


def test_csr_to_ell_matches_jax():
    a = random_matrix(70, 50, 5, seed=2)
    tc, tv = tsp.csr_to_ell(_port(a), dtype=np.float32)
    jc, jv = jsp.csr_to_ell(a, dtype=np.float32)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("need_ap", [True, False])
def test_rap_device(need_ap):
    A = _aniso()
    p = random_matrix(A.n_rows, A.n_rows // 4, 3, seed=7)
    tA, tp = _port(A), _port(p)
    ap, ac, ap_nnz = tsp.rap_device(tA, tp, need_ap=need_ap, device="cpu")
    jap, jac, jap_nnz = jsp.rap_device(A, p, need_ap=need_ap)
    hap = tA.multiply(tp)
    hac = tp.T_multiply(hap)
    assert ap_nnz == jap_nnz == hap.nnz
    _same(ac, jac, tol=1e-12)
    _same(ac, hac, tol=1e-12)
    if need_ap:
        _same(ap, jap)
        _same(ap, hap)
    else:
        assert ap is None and jap is None


def test_rap_device_is_deterministic():
    A = _port(_aniso())
    p = _port(random_matrix(A.n_rows, A.n_rows // 4, 3, seed=7))
    _, first, _ = tsp.rap_device(A, p, device="cpu")
    _, again, _ = tsp.rap_device(A, p, device="cpu")
    np.testing.assert_array_equal(first.indices, again.indices)
    assert first.data.tobytes() == again.data.tobytes()


def test_cap_overflow_retry():
    """A cap of 4 is too narrow: the exact-width second pass runs."""
    a = random_matrix(100, 100, 8, seed=3)
    b = random_matrix(100, 100, 8, seed=4)
    ta, tb = _port(a), _port(b)
    got = tsp.spgemm_device(ta, tb, w_cap=4, device="cpu")
    _same(got, jsp.spgemm_device(a, b, w_cap=4))
    _same(got, ta.multiply(tb))


def test_tree_merge_retry_after_a_cut_group(monkeypatch):
    """P^T (AP) with rows about 1,000 wide from slabs of about 7,800
    candidates: the first cap (about 700) cuts the tree's groups, whose
    entries are then lost; the retry runs at the sum of the group counts
    (at most the column count), cuts nothing and gives the host
    product."""
    a = _port(jst.stencil_grid(jst.laplace_stencil_27pt(), (20, 20, 20)))
    m = sp.random(8000, 1000, density=6 / 1000, random_state=3,
                  format="csr")
    m.sort_indices()
    p = TCSR.from_scipy(m)
    caps = []
    real = tsp._run_ell

    def run_ell(ac, av, bc_d, bv_d, n_rows, n_cols_out, w_cap, *args):
        caps.append(w_cap)
        return real(ac, av, bc_d, bv_d, n_rows, n_cols_out, w_cap, *args)
    monkeypatch.setattr(tsp, "_run_ell", run_ell)
    _, ac, _ = tsp.rap_device(a, p, device="cpu")
    assert len(caps) == 2 and caps[0] < 1000 and caps[1] == 1000
    _same(ac, p.T_multiply(a.multiply(p)))


def test_cap_overflow_after_retry_raises(monkeypatch):
    """When the exact width overflows again, CapOverflow says so."""
    a = _port(random_matrix(100, 100, 8, seed=3))
    real = tsp._finish

    def narrowing(chunks, counts, mxs, n_rows, n_cols_out, w_cap):
        prod, mx = real(chunks, counts, mxs, n_rows, n_cols_out, w_cap)
        return None, mx + 1
    monkeypatch.setattr(tsp, "_finish", narrowing)
    with pytest.raises(tsp.CapOverflow):
        tsp.spgemm_device(a, a, device="cpu")


def test_zero_drop():
    """Exact cancellations: +1 / -1 entries meet on one output."""
    ind = np.array([0, 1, 0, 1], dtype=np.int64)
    indptr = np.array([0, 2, 4], dtype=np.int64)
    a = TCSR(2, 2, indptr, ind, np.array([1.0, -1.0, 2.0, 1.0]))
    b = TCSR(2, 2, indptr, ind, np.ones(4))
    got = tsp.spgemm_device(a, b, device="cpu")
    _same(got, a.multiply(b))
    assert got.nnz == 2
    from raptor_tpu.core.matrix import CSRMatrix as JCSR
    ja = JCSR(2, 2, indptr, ind, a.data)
    jb = JCSR(2, 2, indptr, ind, b.data)
    _same(got, jsp.spgemm_device(ja, jb))


def test_float32_within_single_precision():
    A = _port(_aniso())
    p = _port(random_matrix(A.n_rows, A.n_rows // 4, 3, seed=7))
    _, ac64, _ = tsp.rap_device(A, p, device="cpu")
    _, ac32, _ = tsp.rap_device(A, p, dtype=np.float32, device="cpu")
    np.testing.assert_array_equal(ac32.indptr, ac64.indptr)
    np.testing.assert_array_equal(ac32.indices, ac64.indices)
    assert np.abs(ac32.data - ac64.data).max() < 1e-5 * np.abs(
        ac64.data).max()


# --- whole hierarchies with the device Galerkin product ------------------------

def _levels_match(tml, jml, tol=1e-11):
    assert tml.num_levels == len(jml.levels)
    for tl, jl in zip(tml.levels, jml.levels):
        _same(tl.A.global_csr, jl.A.global_csr, tol)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            _same(tl.P.global_csr, jl.P.global_csr, tol)


def test_rs_hierarchy_rap_device_matches_jax():
    """RS + modified classical on the 36^2 anisotropic problem (JAX's
    test_solver_rap_mode_device_matches_host): device Galerkin products,
    host interpolation, in both packages."""
    jml = JRS(coarsen_type=JCoarsen.RS, interp_type=JInterp.ModClassical)
    jml.rap_mode, jml.interp_mode = "device", "host"
    jml.setup(jst.par_stencil_grid(jst.diffusion_stencil_2d(0.001,
                                                            np.pi / 8),
                                   (36, 36), 1))
    tml = ParRugeStubenSolver(coarsen_type=CoarsenType.RS,
                              interp_type=InterpType.ModClassical)
    tml.rap_mode, tml.interp_mode, tml.device = "device", "host", "cpu"
    tml.setup(tst.par_stencil_grid(tst.diffusion_stencil_2d(0.001,
                                                            np.pi / 8),
                                   (36, 36), 1))
    assert jml.rap_engine_used == tml.rap_engine_used == "device"
    assert all(e == {"interp": "host", "rap": "device"}
               for e in tml.level_engines)
    _levels_match(tml, jml)


@pytest.mark.parametrize("problem", ["aniso25", "lap16"])
def test_sa_hierarchy_rap_device_matches_jax(problem):
    """Smoothed aggregation (need_ap=False) with the device Galerkin
    product in both packages."""
    from raptor_tpu.aggregation.solver import (
        ParSmoothedAggregationSolver as JSA)
    from raptor_tpu_torch import ParSmoothedAggregationSolver
    _, _, theta, relax, sweeps = SA_PROBLEMS[problem]
    jml = JSA(theta, relax_type=getattr(JRelax, relax))
    jml.rap_mode = "device"
    jml.setup(sa_matrix(problem, jst))
    tml = ParSmoothedAggregationSolver(theta,
                                       relax_type=getattr(RelaxType, relax))
    tml.rap_mode, tml.device = "device", "cpu"
    tml.setup(sa_matrix(problem, tst))
    assert all(e == {"rap": "device"} for e in tml.level_engines)
    assert [s[0] for s in tml.rap_stats] == list(range(tml.num_levels - 1))
    _levels_match(tml, jml)
