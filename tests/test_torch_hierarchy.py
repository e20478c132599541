"""Parity of the port's device solve with the JAX package's, on the
same hierarchy: JAX sets it up, ``raptor_tpu_torch.convert`` carries it
across, and both packages pack and solve it (the port on CPU tensors, where
the DIA/BDIA kernel wrappers run their plain versions).

JAX runs on the 8-device CPU mesh of tests/conftest.py with x64;
``RAPTOR_TPU_WELL=0`` keeps it to the structural format rules the port
has.
"""

import numpy as np
import pytest
import scipy.linalg

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.device import relax as jrelax  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu_torch import convert  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.device import relax as trelax  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)

from _torch_parity import (  # noqa: E402
    jax_hierarchy, port_hierarchy, rhs, to_port)

N = 64
# the solves run on 32 x 32 (5 levels), which keeps the JAX compiles short
N_SOLVE = 32


@pytest.fixture(autouse=True)
def _structural_formats(monkeypatch):
    monkeypatch.setenv("RAPTOR_TPU_WELL", "0")


@pytest.mark.parametrize("S", [1, 8])
def test_build_relax_and_chebyshev_match_jax(S):
    jml = jax_hierarchy(N, S)
    jA_host = jml.levels[0].A
    mesh = jpar.make_mesh(S)
    jA = jpar.device_put_matrix(jA_host, mesh, dtype=jnp.float64,
                                need_transpose=False)
    jRX = jrelax.build_relax(jA_host, mesh, jA, dtype=jnp.float64, need=())
    tA_host = to_port(jA_host)
    tA = tpar.device_put_matrix(tA_host, need_transpose=False, device="cpu")
    tRX = trelax.build_relax(tA_host, tA)
    for f in ("inv_diag", "has_diag"):
        assert getattr(tRX, f).numpy().tobytes() == \
            np.asarray(getattr(jRX, f)).tobytes(), f
    assert (tRX.cheb_lo, tRX.cheb_hi) == (jRX.cheb_lo, jRX.cheb_hi)
    part = jA_host.partition
    rng = np.random.default_rng(S)
    x, b = rng.standard_normal((2, part.global_num_rows))
    jx, jb = (jpar.device_put_vector(v, part.row_bounds, jA.rows_pad, mesh)
              for v in (x, b))
    tx, tb = (tpar.device_put_vector(v, part.row_bounds, tA.rows_pad,
                                     device="cpu") for v in (x, b))
    want = np.asarray(jrelax.relax(mesh, "chebyshev", jA, jRX, jx, jb,
                                   num_sweeps=3))
    got = trelax.chebyshev(tA, tRX, tx, tb, 3).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("S,lane_pad", [(1, 1), (8, 1), (8, 128)])
def test_solve_histories_match_jax(S, lane_pad):
    """f64 V-cycle solves to 1e-9: the same number of cycles, and residual
    histories equal to 1e-9 relative. A relative residual r carries
    rounding of about 1e-16 / r of its own, so entries below 1e-7 are held
    to 1e-16 absolute instead (the history starts at 1)."""
    jml = jax_hierarchy(N_SOLVE, S)
    tml = port_hierarchy(jml)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(S), dtype=jnp.float64,
                             lane_pad=lane_pad)
    tdh = DeviceHierarchy(tml, dtype=torch.float64, lane_pad=lane_pad,
                          device="cpu")
    jdh.solve_tol = tdh.solve_tol = 1e-9
    assert [lv.A.on_format for lv in tdh.levels] == \
        [lv.A.on_format for lv in jdh.levels]
    assert [lv.P.on_format for lv in tdh.levels[:-1]] == \
        [lv.P.on_format for lv in jdh.levels[:-1]]
    b = rhs(jml)
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    tr = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b))
    assert tr.n_iters == int(jr.n_iters) > 3
    assert not tr.stalled and not bool(jr.stalled)
    jres = np.asarray(jr.res)
    np.testing.assert_allclose(tr.res, jres, rtol=1e-9, atol=1e-16)
    np.testing.assert_allclose(tdh.host(tr.x), jdh.host(jr.x), rtol=0,
                               atol=1e-9 * np.abs(jdh.host(jr.x)).max())


def test_solve_iterations_independent_of_shards():
    """The same hierarchy solved at 1 and 8 shards takes the same number
    of V-cycles."""
    iters = []
    for S in (1, 8):
        tdh = DeviceHierarchy(port_hierarchy(jax_hierarchy(N_SOLVE, S)),
                              lane_pad=128, device="cpu")
        tdh.solve_tol = 1e-9
        b = rhs(jax_hierarchy(N_SOLVE, S))
        iters.append(tdh.solve(tdh.vector(np.zeros_like(b)),
                               tdh.vector(b)).n_iters)
    assert iters[0] == iters[1]


@pytest.mark.parametrize("S", [8])
def test_solve_mixed_matches_jax(S):
    """Mixed-precision refinement on an f32 hierarchy: both reach 1e-8,
    within one refinement of each other."""
    jml = jax_hierarchy(N_SOLVE, S)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(S), dtype=jnp.float32)
    tdh = DeviceHierarchy(port_hierarchy(jml), dtype=torch.float32,
                          lane_pad=1, device="cpu")
    b = rhs(jml)
    jx, jhist = jdh.solve_mixed(np.zeros_like(b), b, tol=1e-8)
    tx, thist = tdh.solve_mixed(np.zeros_like(b), b, tol=1e-8)
    assert jhist[-1] <= 1e-8 and thist[-1] <= 1e-8
    assert abs(len(thist) - len(jhist)) <= 1
    a = jml.levels[0].A.global_csr.to_scipy()
    assert np.linalg.norm(b - a @ tx) <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("S", [1, 3])
def test_coarse_solve_with_pivoting(S):
    """A coarsest operator whose LU pivots rows: the 0-based scipy pivots
    are applied as LAPACK's sequential swaps."""
    rng = np.random.default_rng(11)
    n = 40
    dense = rng.standard_normal((n, n))     # unsymmetric, no dominance
    lu, piv = scipy.linalg.lu_factor(dense)
    assert (piv != np.arange(n)).any()
    import scipy.sparse as sp
    csr = sp.csr_matrix(dense)
    bounds = np.array([0, 15, 27, 40]) if S == 3 else np.array([0, n])
    ml = convert.hierarchy_from_numpy(
        [((csr.indptr, csr.indices, csr.data, (n, n), bounds, bounds),
          None)], (lu, piv))
    dh = DeviceHierarchy(ml, lane_pad=1, device="cpu")
    b = rng.standard_normal(n)
    x = dh.host(dh.vcycle(dh.vector(np.zeros(n)), dh.vector(b)))
    np.testing.assert_allclose(x, np.linalg.solve(dense, b), rtol=1e-10,
                               atol=1e-12)
