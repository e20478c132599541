"""TAP through the port's V-cycle (the ``tap_amg`` knob), the three tests
of tests/test_tap_amg.py ported: the port's TAP solve against its own
plain solve (equal cycles, residual histories to 1e-12, x to 1e-10) and
against the JAX package's TAP solve (equal cycles, histories to 1e-9
relative), on Ruge-Stuben hierarchies from the global and the
distributed setup and on a smoothed-aggregation hierarchy. Then each of
the seven smoothers, one V-cycle with and without TAP.

The port sets up its own hierarchies (bit-equal to JAX's,
tests/test_torch_dist_setup.py). JAX runs on the 8-device CPU mesh of
tests/conftest.py with x64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.aggregation.solver import (  # noqa: E402
    ParSmoothedAggregationSolver as JSA)
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu_torch.aggregation.solver import (  # noqa: E402
    ParSmoothedAggregationSolver as TSA)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as TRS)

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _structural_formats(monkeypatch):
    monkeypatch.setenv("RAPTOR_TPU_WELL", "0")


def _rs(pkg, n, coarsen, interp, relax, setup_mode="global"):
    """Both packages' RS setup of the n x n flagship problem on 8 shards
    (host engines)."""
    st, types, cls = ((tst, tt, TRS) if pkg == "port" else (jst, jt, JRS))
    ml = cls(0.25, getattr(types.CoarsenType, coarsen),
             getattr(types.InterpType, interp),
             relax_type=getattr(types.RelaxType, relax))
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup_mode = setup_mode
    A = st.par_stencil_grid(st.diffusion_stencil_2d(*ANISO), (n, n), 8)
    ml.setup(A)
    return A, ml


def _port_solve(ml, b, tap_amg, hl=(2, 4)):
    ml.tap_amg = tap_amg
    mesh = tpar.make_mesh2(*hl) if tap_amg >= 0 else None
    dh = DeviceHierarchy(ml, device="cpu", mesh=mesh)
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    return r, dh.host(r.x)


def _jax_tap_solve(ml, b, hl=(2, 4)):
    ml.tap_amg = 0
    dh = JDH(ml, jpar.make_mesh2(*hl))
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    k = int(r.n_iters)
    return k, np.asarray(r.res)[:k + 1], dh.host(r.x)


def _hold(tml, jml, b, hl=(2, 4)):
    """The port's TAP solve against its plain solve and JAX's TAP solve;
    returns the port's plain cycle count."""
    plain, x_plain = _port_solve(tml, b, -1)
    tap, x_tap = _port_solve(tml, b, 0, hl)
    k = plain.n_iters
    assert tap.n_iters == k
    np.testing.assert_allclose(tap.res[:k + 1], plain.res[:k + 1],
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(x_tap, x_plain, rtol=0, atol=1e-10)
    jk, jres, jx = _jax_tap_solve(jml, b, hl)
    assert jk == k
    np.testing.assert_allclose(tap.res[:k + 1], jres, rtol=1e-9,
                               atol=1e-16)
    np.testing.assert_allclose(x_tap, jx, rtol=0, atol=1e-10)
    return k


def test_tap_amg_matches_plain():
    A, tml = _rs("port", 25, "CLJP", "ModClassical", "SOR")
    _, jml = _rs("jax", 25, "CLJP", "ModClassical", "SOR")
    b = A.mult(np.ones(A.global_num_rows))
    k = _hold(tml, jml, b)
    # TAP from level 1 only: a mixed plain / TAP hierarchy
    mixed, _ = _port_solve(tml, b, 1)
    assert mixed.n_iters == k


@pytest.mark.parametrize("coarsen,interp,relax", [
    ("HMIS", "Extended", "Chebyshev"), ("CLJP", "ModClassical", "SOR")])
def test_tap_amg_with_distributed_setup(coarsen, interp, relax):
    A, tml = _rs("port", 30, coarsen, interp, relax, "distributed")
    _, jml = _rs("jax", 30, coarsen, interp, relax, "distributed")
    assert tml.num_levels == jml.num_levels
    _hold(tml, jml, A.mult(np.ones(A.global_num_rows)))


def test_tap_amg_sa_hierarchy():
    """TAP through a smoothed-aggregation hierarchy, on the 4 x 2 layout."""
    tA = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (30, 30), 8)
    jA = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (30, 30), 8)
    tml = TSA(0.25, relax_type=tt.RelaxType.Chebyshev)
    jml = JSA(0.25, relax_type=jt.RelaxType.Chebyshev)
    for ml, A in ((tml, tA), (jml, jA)):
        ml.num_smooth_sweeps = 2
        ml.rap_mode = "host"
        ml.setup(A)
    _hold(tml, jml, tA.mult(np.ones(tA.global_num_rows)), hl=(4, 2))


@pytest.mark.parametrize("relax", ["Jacobi", "SOR", "SSOR", "MCSOR",
                                   "MCSSOR", "L1Jacobi", "Chebyshev"])
def test_each_smoother_one_cycle_tap_equals_plain(relax):
    A, ml = _rs("port", 25, "HMIS", "Extended", relax)
    ml.num_smooth_sweeps = 2
    ml.relax_weight = 0.8
    b = A.mult(np.random.default_rng(5).standard_normal(A.global_num_rows))
    out = []
    for tap_amg in (-1, 0):
        ml.tap_amg = tap_amg
        dh = DeviceHierarchy(ml, device="cpu",
                             mesh=tpar.make_mesh2(2, 4))
        x = dh.vcycle(dh.vector(np.zeros_like(b)), dh.vector(b))
        out.append(dh.host(x))
    np.testing.assert_allclose(out[1], out[0], rtol=0,
                               atol=1e-12 * np.abs(out[0]).max())
