"""The blocked (BSR) AMG slice of the port against the JAX package, end to
end: ``ParBSRRugeStubenSolver``'s hierarchies bit for bit, the device
leaves of ``BSRDeviceHierarchy``, one V-cycle, a JAX hierarchy carried
across by ``convert``, BSR-PCG histories and the entry points' defaults
(the solve histories and the card's padding on the CPU are in
tests/test_torch_bsr_amg_solve.py, which takes this file's helpers).

The problem is tests/test_bsr_amg.py's: 24 x 12 Q1 plane-stress
elasticity (2 dofs a node), theta 0.25, RS coarsening with modified
classical interpolation and classical strength unless a case says
otherwise, b = A 1. JAX runs on the CPU mesh of tests/conftest.py; the
port on CPU tensors, where the kernel wrappers run their plain versions.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.types import (  # noqa: E402
    CoarsenType as JCoarsenType, InterpType as JInterpType,
    StrengthType as JStrengthType)
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.krylov.cg import cg as jcg  # noqa: E402
from raptor_tpu.multilevel.bsr_hierarchy import (  # noqa: E402
    BSRDeviceHierarchy as JBSRDeviceHierarchy,
    ParBSRRugeStubenSolver as JParBSRRugeStubenSolver)
from raptor_tpu_torch import (  # noqa: E402
    BSRDeviceHierarchy, ParBSRRugeStubenSolver, convert, par_fem)
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, StrengthType)
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.device.bsr import device_put_bsr  # noqa: E402
from raptor_tpu_torch.krylov.cg import cg  # noqa: E402

from _torch_parity import arrays  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

NX, NY = 24, 12
LEVELS = [624, 152, 40]
PHASES = {"strength", "cf_splitting", "interpolation", "RAP"}
# (coarsening, interpolation, strength) of the hierarchy cases
CASES = {"rs": ("RS", "ModClassical", "Classical"),
         "pmis": ("PMIS", "ModClassical", "Classical"),
         "hmis": ("HMIS", "ModClassical", "Classical"),
         "cljp": ("CLJP", "ModClassical", "Classical"),
         "falgout": ("Falgout", "ModClassical", "Classical"),
         "direct": ("RS", "Direct", "Classical"),
         "symmetric": ("RS", "ModClassical", "Symmetric")}


@functools.lru_cache(maxsize=None)
def _jax_ml(case, n_shards):
    c, i, s = CASES[case]
    A, _ = jpar_fem("elasticity", NX, NY, n_shards)
    ml = JParBSRRugeStubenSolver(
        2, strong_threshold=0.25, coarsen_type=getattr(JCoarsenType, c),
        interp_type=getattr(JInterpType, i),
        strength_type=getattr(JStrengthType, s))
    ml.setup(A)
    return ml


@functools.lru_cache(maxsize=None)
def _port_ml(case, n_shards):
    c, i, s = CASES[case]
    A, _ = par_fem("elasticity", NX, NY, n_shards)
    ml = ParBSRRugeStubenSolver(
        2, strong_threshold=0.25, coarsen_type=getattr(CoarsenType, c),
        interp_type=getattr(InterpType, i),
        strength_type=getattr(StrengthType, s))
    ml.setup(A)
    return ml


def _same_bits(t, j):
    """A port CSRMatrix (or ParCSRMatrix, with its partition) bit-equal to
    a JAX-package one."""
    if hasattr(j, "partition"):
        for f in ("row_bounds", "col_bounds"):
            np.testing.assert_array_equal(getattr(t.partition, f),
                                          getattr(j.partition, f))
        t, j = t.global_csr, j.global_csr
    assert t.shape == (j.n_rows, j.n_cols)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.data.tobytes() == np.asarray(j.data, np.float64).tobytes()


def _rhs(ml):
    a = ml.levels[0].A
    return a.global_csr.to_scipy() @ np.ones(a.global_num_rows)


@pytest.mark.parametrize("case,n_shards", [("rs", 1), ("rs", 4)] + [
    (c, 1) for c in CASES if c != "rs"])
def test_bsr_hierarchy_bit_equal_to_jax(case, n_shards):
    """Every level's A and P with their partitions, the nodal component
    prolongators, the coarse LU and the setup phases."""
    jml, tml = _jax_ml(case, n_shards), _port_ml(case, n_shards)
    assert tml.num_levels == jml.num_levels >= 3
    if case == "rs":
        assert [lv.A.global_num_rows for lv in tml.levels] == LEVELS
    for tl, jl in zip(tml.levels, jml.levels):
        _same_bits(tl.A, jl.A)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            _same_bits(tl.P, jl.P)
    assert len(tml.p_nodals) == len(jml.p_nodals) == tml.num_levels - 1
    for tp, jp in zip(tml.p_nodals, jml.p_nodals):
        assert len(tp) == len(jp) == 2
        for t, j in zip(tp, jp):
            _same_bits(t, j)
    for t, j in zip(tml.coarse_lu, jml.coarse_lu):
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()
    assert set(tml.setup_times.times) == set(jml.setup_times.times) == PHASES
    assert [set(d) for d in tml.setup_level_times] == \
        [PHASES] * (tml.num_levels - 1)


def test_bsr_helpers_match_jax():
    """nodal_matrix, expand_prolongator and block_partition."""
    from raptor_tpu.multilevel import bsr_hierarchy as jb
    from raptor_tpu_torch.multilevel import bsr_hierarchy as tb
    jml, tml = _jax_ml("rs", 4), _port_ml("rs", 4)
    _same_bits(tb.nodal_matrix(tml.levels[0].A.global_csr, 2),
               jb.nodal_matrix(jml.levels[0].A.global_csr, 2))
    _same_bits(tb.expand_prolongator(tml.p_nodals[0][0], 2),
               jb.expand_prolongator(jml.p_nodals[0][0], 2))
    tp, jp = tb.block_partition(650, 650, 2, 4), jb.block_partition(
        650, 650, 2, 4)
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))


@functools.lru_cache(maxsize=None)
def _jax_dh(n_shards, sweeps, use="solve"):
    """JAX's device hierarchy, one for each ``use``: its ``solve`` compiles
    once with the tolerance and cap of its first call and keeps them."""
    return JBSRDeviceHierarchy(_jax_ml("rs", n_shards),
                               jpar.make_mesh(n_shards), sweeps=sweeps)


def _port_dh(n_shards, sweeps, lane_pad=1, ml=None):
    return BSRDeviceHierarchy(ml or _port_ml("rs", n_shards), sweeps=sweeps,
                              lane_pad=lane_pad, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_solve(n_shards, sweeps):
    """JAX's f64 blocked solve to 1e-6 with b = A 1: (x, history, cycles)."""
    jdh = _jax_dh(n_shards, sweeps)
    b = _rhs(_jax_ml("rs", n_shards))
    x, hist, k = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b),
                           tol=1e-6, max_iter=100)
    return jdh.host(np.asarray(x)), np.asarray(hist), int(k)


def _port_solve(dh):
    b = _rhs(_port_ml("rs", 1))
    x, hist, k = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b),
                          tol=1e-6, max_iter=100)
    return dh.host(x), hist, k


@pytest.mark.parametrize("n_shards", [1, 4])
def test_bsr_device_leaves_equal_jax(n_shards):
    """Each level's blocked operator, inverted diagonal blocks, Chebyshev
    interval and nodal transfer formats; the coarse LU plumbing."""
    jdh, tdh = _jax_dh(n_shards, 3), _port_dh(n_shards, 3)
    assert len(tdh.levels) == len(jdh.levels)
    for tl, jl in zip(tdh.levels, jdh.levels):
        assert tl.inv_diag.numpy().tobytes() == \
            np.asarray(jl.inv_diag).tobytes()
        assert (tl.cheb_lo, tl.cheb_hi) == (jl.cheb_lo, jl.cheb_hi)
        assert tl.Ab.on_blocks.numpy().tobytes() == \
            np.asarray(jl.Ab.on_blocks).tobytes()
        assert (tl.Pn is None) == (jl.Pn is None)
        if tl.Pn is not None:
            for tp, jp in zip(tl.Pn + tl.PnT, jl.Pn + jl.PnT):
                assert tp.on_format == jp.on_format
                assert (tp.rows_pad, tp.cols_pad) == (jp.rows_pad,
                                                      jp.cols_pad)
    np.testing.assert_array_equal(tdh.gather_idx.numpy(),
                                  np.asarray(jdh.gather_idx))
    np.testing.assert_array_equal(tdh.coarse_take.numpy(),
                                  np.asarray(jdh.coarse_take))
    np.testing.assert_array_equal(tdh.piv.numpy(),
                                  np.asarray(jdh.piv) + 1)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_one_vcycle_matches_jax(n_shards):
    """One f64 V-cycle from zero (JAX's solve stopped after one cycle) to
    1e-12 relative."""
    jdh, tdh = _jax_dh(n_shards, 3, "one cycle"), _port_dh(n_shards, 3)
    b = _rhs(_jax_ml("rs", n_shards))
    jx, _, k = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b),
                         tol=0.0, max_iter=1)
    assert k == 1
    bd = tdh.vector(b)
    x = tdh.host(tdh.vcycle(torch.zeros_like(bd), bd))
    jx = jdh.host(np.asarray(jx))
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12 * np.abs(jx).max())


def _assert_same_history(t, j):
    (tx, th, tk), (jx, jh, jk) = t, j
    assert tk == jk > 3
    np.testing.assert_allclose(th, jh, rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9 * np.abs(jx).max())


def test_carried_jax_hierarchy_gives_jax_history():
    """JAX's own hierarchy, carried across as numpy arrays by
    ``convert.bsr_hierarchy_from_numpy``, solves like JAX."""
    jml = _jax_ml("rs", 4)
    levels = [(arrays(lv.A), None if lv.P is None else arrays(lv.P))
              for lv in jml.levels]
    p_nodals = [[(p.indptr, p.indices, p.data, (p.n_rows, p.n_cols))
                 for p in comps] for comps in jml.p_nodals]
    ml = convert.bsr_hierarchy_from_numpy(levels, p_nodals, 2, jml.coarse_lu)
    _assert_same_history(_port_solve(_port_dh(4, 3, ml=ml)),
                         _jax_solve(4, 3))
    with pytest.raises(ValueError, match="nodal prolongators"):
        convert.bsr_hierarchy_from_numpy(levels, p_nodals[:1], 2,
                                         jml.coarse_lu)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_bsr_pcg_matches_jax(n_shards):
    """f64 PCG on the scalar level-0 A (the blocked partition) with the
    blocked V-cycle as preconditioner, to 1e-10 within 100 iterations
    (tests/test_bsr_amg.py::test_bsr_pcg): JAX's iteration count and
    history to 1e-9."""
    jml, tml = _jax_ml("rs", n_shards), _port_ml("rs", n_shards)
    mesh = jpar.make_mesh(n_shards)
    jA = jpar.device_put_matrix(jml.levels[0].A, mesh, dtype=jnp.float64,
                                need_transpose=False)
    Ab = tml.levels[0].A
    b = _rhs(tml)
    rb = Ab.partition.row_bounds
    jr = jcg(mesh, jA, *(jpar.device_put_vector(v, rb, jA.rows_pad, mesh)
                         for v in (np.zeros_like(b), b)),
             tol=1e-10, max_iter=100, precond=_jax_dh(n_shards, 3)
             .precond_pack())
    tA = tpar.device_put_matrix(Ab, dtype=torch.float64,
                                need_transpose=False, device="cpu")
    tr = cg(tA, *(tpar.device_put_vector(v, rb, tA.rows_pad, device="cpu")
                  for v in (np.zeros_like(b), b)),
            tol=1e-10, max_iter=100,
            precond=_port_dh(n_shards, 3).precond_pack())
    k = int(jr.n_iters)
    assert tr.n_iters == k < 40 and not tr.indefinite
    assert tr.res[k] < 1e-10
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9,
                               atol=1e-16)


def test_default_device_raises_without_cuda(monkeypatch):
    """device_put_bsr and BSRDeviceHierarchy default to CUDA and raise
    without it; they never drop to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ml = _port_ml("rs", 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_put_bsr(ml.levels[0].A, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BSRDeviceHierarchy(ml)
