"""The rest of the port's host library against the JAX package's:
``core.vector.ParVector``, ``utils.config.AMGConfig`` (a dict written by
JAX's ``to_dict`` builds, through the port's ``from_dict(...).build()``,
the same hierarchy bit for bit: RS with CLJP + SSOR as
tests/test_aux.py::test_config_roundtrip_and_build, and smoothed
aggregation), ``multilevel.serial.SerialMultilevel`` (JAX's iterations and
residuals; tests/test_serial_multilevel.py's one-shard device check),
``external`` (``to_torch`` / ``from_torch``, ``solve_external`` in JAX's
iterations, tests/test_external.py) and ``utils.hostmem.pin_arena`` (JAX's
return value, called by the port's setup and ``stencil_grid``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu import external as jext  # noqa: E402
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.core.partition import Partition as JPartition  # noqa: E402
from raptor_tpu.core.vector import ParVector as JParVector  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.serial import (  # noqa: E402
    SerialMultilevel as JSerial)
from raptor_tpu.utils import config as jcfg  # noqa: E402
from raptor_tpu.utils import hostmem as jhostmem  # noqa: E402
from raptor_tpu_torch import external as text  # noqa: E402
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.core.vector import ParVector  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel import par_multilevel as tpml  # noqa
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.serial import SerialMultilevel  # noqa
from raptor_tpu_torch.utils import config as tcfg  # noqa: E402
from raptor_tpu_torch.utils import hostmem  # noqa: E402

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


def _bits(t, j):
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape
    assert t.tobytes() == j.tobytes()


def _aniso(n, shards=1):
    return (tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                                 shards),
            jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (n, n),
                                 shards))


# --- ParVector ---------------------------------------------------------------

def _vectors(n=41, shards=4):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    tp, jp = Partition.create(n, n, shards), JPartition.create(n, n, shards)
    return ((ParVector(x.copy(), tp), ParVector(y.copy(), tp)),
            (JParVector(x.copy(), jp), JParVector(y.copy(), jp)))


@pytest.mark.parametrize("p", [1, 2, 3])
def test_par_vector_reductions_match_jax(p):
    (tx, ty), (jx, jy) = _vectors()
    assert tx.norm(p) == jx.norm(p)
    assert tx.inner_product(ty) == jx.inner_product(jy)


def test_par_vector_updates_match_jax():
    """``axpy``, ``scale``, ``copy``, ``set_const_value``, ``zeros`` and
    the shard slices, bit for bit."""
    (tx, ty), (jx, jy) = _vectors()
    _bits(tx.axpy(ty, 0.375).values, jx.axpy(jy, 0.375).values)
    _bits(tx.scale(-1.5).values, jx.scale(-1.5).values)
    tc, jc = tx.copy(), jx.copy()
    tc.set_const_value(2.0)
    jc.set_const_value(2.0)
    _bits(tc.values, jc.values)
    _bits(tx.values, jx.values)             # the copy is its own
    for s in range(4):
        _bits(tx.local_slice(s), jx.local_slice(s))
    _bits(tx.local, jx.local)
    _bits(ParVector.zeros(tx.partition).values,
          JParVector.zeros(jx.partition).values)


# --- AMGConfig ---------------------------------------------------------------

CONFIGS = {
    # tests/test_aux.py::test_config_roundtrip_and_build
    "rs_cljp_ssor": dict(method="ruge_stuben", strong_threshold=0.25,
                         coarsen_type=jt.CoarsenType.CLJP,
                         interp_type=jt.InterpType.ModClassical,
                         relax_type=jt.RelaxType.SSOR, max_iterations=42,
                         rap_mode="host", interp_mode="host"),
    "rs_chebyshev": dict(method="ruge_stuben", strong_threshold=0.25,
                         coarsen_type=jt.CoarsenType.RS,
                         interp_type=jt.InterpType.ModClassical,
                         relax_type=jt.RelaxType.Chebyshev,
                         num_smooth_sweeps=3, rap_mode="host",
                         interp_mode="host"),
    "sa": dict(method="smoothed_agg", strong_threshold=0.25,
               rap_mode="host"),
}
KNOBS = ("strong_threshold", "strength_type", "relax_type",
         "num_smooth_sweeps", "relax_weight", "max_coarse", "max_levels",
         "solve_tol", "max_iterations", "tap_amg", "rap_mode",
         "interp_mode", "setup_mode")


def _port_config(name):
    """The JAX configuration's ``to_dict`` read by the port's
    ``from_dict``."""
    d = jcfg.AMGConfig(**CONFIGS[name]).to_dict()
    return tcfg.AMGConfig.from_dict(d), d


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_dicts_cross_the_packages(name):
    """JAX's dict builds the port's configuration, whose dict is JAX's and
    which survives its own round trip."""
    cfg, d = _port_config(name)
    assert cfg.to_dict() == d
    assert tcfg.AMGConfig.from_dict(cfg.to_dict()) == cfg
    assert jcfg.AMGConfig.from_dict(cfg.to_dict()) == jcfg.AMGConfig(
        **CONFIGS[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_builds_the_same_solver_knobs(name):
    cfg, _ = _port_config(name)
    tml = cfg.build()
    jml = jcfg.AMGConfig(**CONFIGS[name]).build()
    assert type(tml).__name__ == type(jml).__name__
    for k in KNOBS + (("coarsen_type", "interp_type", "interp_filter")
                      if name != "sa" else
                      ("agg_type", "prolong_type", "prolong_smooth_steps",
                       "prolong_weight")):
        tv, jv = getattr(tml, k), getattr(jml, k)
        assert (tv.name if hasattr(tv, "name") else tv) == (
            jv.name if hasattr(jv, "name") else jv), k


def _levels_equal(tml, jml):
    assert tml.num_levels == jml.num_levels > 1
    for tl, jl in zip(tml.levels, jml.levels):
        for tm_, jm_ in ((tl.A, jl.A), (tl.P, jl.P)):
            if jm_ is None:
                assert tm_ is None
                continue
            for f in ("indptr", "indices", "data"):
                _bits(getattr(tm_.global_csr, f), getattr(jm_.global_csr, f))
            _bits(tm_.partition.row_bounds, jm_.partition.row_bounds)
    for a, b in zip(tml.coarse_lu, jml.coarse_lu):
        _bits(a, b)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("shards", [1, 2])
def test_config_builds_the_same_hierarchy(name, shards):
    """The hierarchy a JAX dict builds in the port is JAX's, bit for bit
    (levels, P, partitions, coarse LU), weights given or not."""
    ta, ja = _aniso(20, shards)
    cfg, _ = _port_config(name)
    weights = (None if name != "rs_cljp_ssor" else
               np.random.default_rng(3).random(ta.global_num_rows))
    tml = cfg.build(weights)
    jml = jcfg.AMGConfig(**CONFIGS[name]).build(weights)
    tml.setup(ta)
    jml.setup(ja)
    _levels_equal(tml, jml)


def test_config_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tcfg.AMGConfig(method="multigrid").build()


# --- SerialMultilevel --------------------------------------------------------

def _cljp(n=25, relax="SOR"):
    """tests/test_serial_multilevel.py's hierarchy (CLJP + modified
    classical, theta 0.25, the default smoother) in both packages."""
    from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver
    ta, ja = _aniso(n)
    tml = tpml.ParRugeStubenSolver(0.25, tt.CoarsenType.CLJP,
                                   tt.InterpType.ModClassical,
                                   relax_type=tt.RelaxType[relax])
    jml = ParRugeStubenSolver(0.25, jt.CoarsenType.CLJP,
                              jt.InterpType.ModClassical,
                              relax_type=jt.RelaxType[relax])
    tml.setup(ta)
    jml.setup(ja)
    return ta, tml, jml


@pytest.mark.parametrize("relax", ["SOR", "SSOR", "Jacobi"])
def test_serial_solve_matches_jax(relax):
    """The same cycles, residuals to 1e-12 and x to 1e-12 of max |x|."""
    ta, tml, jml = _cljp(relax=relax)
    b = ta.mult(np.ones(ta.global_num_rows))
    tx, tres, tit = SerialMultilevel(tml).solve(np.zeros_like(b), b)
    jx, jres, jit = JSerial(jml).solve(np.zeros_like(b), b)
    assert tit == jit > 3
    np.testing.assert_allclose(tres, jres, rtol=1e-12, atol=0)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-12 * np.abs(jx).max())


def test_serial_matches_the_one_shard_device_solve():
    """tests/test_serial_multilevel.py on the port: the host V-cycles and
    the one-shard device solve in float64 take the same cycles, residual
    histories within rtol 1e-5, x within 1e-8."""
    ta, tml, _ = _cljp()
    b = ta.mult(np.ones(ta.global_num_rows))
    sx, sres, sit = SerialMultilevel(tml).solve(np.zeros_like(b), b)
    dh = DeviceHierarchy(tml, device="cpu")
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    assert r.n_iters == sit
    np.testing.assert_allclose(r.res[:sit + 1], sres, rtol=1e-5)
    np.testing.assert_allclose(dh.host(r.x), sx, atol=1e-8)


def test_serial_needs_a_setup():
    with pytest.raises(ValueError, match="setup"):
        SerialMultilevel(tpml.ParRugeStubenSolver(0.25))


# --- external ----------------------------------------------------------------

def test_torch_round_trip_matches_jax():
    """``to_torch`` gives JAX's tensor and ``from_torch`` reads JAX's
    tensor back into the same arrays (tests/test_external.py)."""
    t = tst.stencil_grid(tst.diffusion_stencil_2d(*ANISO), (17, 19))
    j = jst.stencil_grid(jst.diffusion_stencil_2d(*ANISO), (17, 19))
    tt_, jt_ = text.to_torch(t, device="cpu"), jext.to_torch(j)
    assert tt_.layout == jt_.layout == torch.sparse_csr
    for f in ("crow_indices", "col_indices", "values"):
        assert torch.equal(getattr(tt_, f)(), getattr(jt_, f)())
    x = np.random.default_rng(0).random(t.n_cols)
    y = (tt_ @ torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, t.mult(x), rtol=1e-11, atol=1e-13)
    for back, ref in ((text.from_torch(jt_), j), (text.from_torch(
            tt_.to_dense()), t)):
        for f in ("indptr", "indices", "data"):
            _bits(getattr(back, f), getattr(ref, f))


def test_to_torch_defaults_to_the_card():
    """``to_torch`` puts the tensor on CUDA unless asked for the CPU, and
    raises where CUDA is asked for and absent (no drop to the host)."""
    t = tst.stencil_grid(tst.diffusion_stencil_2d(*ANISO), (5, 6))
    if torch.cuda.is_available():
        assert text.to_torch(t).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            text.to_torch(t)
    assert text.to_torch(t, device="cpu").device.type == "cpu"


def _ssor_pair(n=40):
    """tests/test_external.py's hierarchy: RS, theta 0.25, SSOR."""
    from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver
    ta, ja = _aniso(n)
    tml = tpml.ParRugeStubenSolver(0.25, relax_type=tt.RelaxType.SSOR)
    jml = ParRugeStubenSolver(0.25, relax_type=jt.RelaxType.SSOR)
    tml.setup(ta)
    jml.setup(ja)
    return ta, tml, jml


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_solve_external_takes_jax_iterations(solver):
    """scipy's Krylov solvers with the host V-cycle as M: JAX's info and
    iterations, x to 1e-10 of max |x|; cg to 1e-10 in under 30 (the JAX
    test's bound)."""
    ta, tml, jml = _ssor_pair()
    b = ta.mult(np.ones(ta.global_num_rows))
    tx, tinfo, tit = text.solve_external(tml, b, solver=solver, tol=1e-10)
    jx, jinfo, jit = jext.solve_external(jml, b, solver=solver, tol=1e-10)
    assert (tinfo, tit) == (jinfo, jit)
    assert tinfo == 0
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10 * np.abs(jx).max())
    if solver == "cg":
        assert tit < 30
        assert np.linalg.norm(b - ta.mult(tx)) / np.linalg.norm(b) < 1e-9


def test_amg_preconditioner_matches_jax():
    ta, tml, jml = _ssor_pair()
    b = ta.mult(np.ones(ta.global_num_rows))
    e, je = text.amg_preconditioner(tml) @ b, jext.amg_preconditioner(jml) @ b
    np.testing.assert_allclose(e, je, rtol=0, atol=1e-14 * np.abs(je).max())
    assert np.linalg.norm(b - ta.mult(e)) < np.linalg.norm(b)


# --- pin_arena -----------------------------------------------------------------

def test_pin_arena_returns_what_jax_returns():
    assert hostmem.pin_arena() == jhostmem.pin_arena()
    assert hostmem.pin_arena(prefault_bytes=1 << 20) == jhostmem.pin_arena(
        prefault_bytes=1 << 20)


def test_setup_and_stencil_grid_pin_the_arena(monkeypatch):
    """The port's setup and ``stencil_grid`` call ``pin_arena``, as JAX's
    do (raptor_tpu/multilevel/par_multilevel.py:177-179,
    raptor_tpu/gallery/stencils.py:56-59), and the hierarchy is the one
    set up without the spy."""
    calls = []

    def spy(*args, **kw):
        calls.append("call")
        return hostmem.pin_arena(*args, **kw)

    monkeypatch.setattr(tst, "pin_arena", spy)
    monkeypatch.setattr(tpml, "pin_arena", spy)
    ta, _ = _aniso(12)
    assert len(calls) == 1
    ml = tpml.ParRugeStubenSolver(0.25)
    ml.setup(ta)
    assert len(calls) == 2
    monkeypatch.undo()
    ref = tpml.ParRugeStubenSolver(0.25)
    ref.setup(_aniso(12)[0])
    for a, b in zip(ml.levels, ref.levels):
        _bits(a.A.global_csr.data, b.A.global_csr.data)
