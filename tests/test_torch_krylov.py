"""Parity of the port's Krylov solvers (raptor_tpu_torch.krylov) with the
JAX package's (raptor_tpu.krylov): CG, the BiCGStab family and restarted
GMRES, plain and AMG-preconditioned, in float64 on CPU tensors: the same
iteration counts and residual histories equal to 1e-9. Then the
indefiniteness flag, and a float64 CG with a float32 preconditioner.

The preconditioned solvers run on the 2-D problem of
examples/benchmark_pcg.py (CLJP + modified classical + Chebyshev(3)),
cut to two levels so that JAX compiles each solve in seconds. The plain
solvers run on the same fine operator shifted by the identity: on the
unshifted one a plain solve takes 70-110 iterations, and the rounding of
a reordered sum grows along them until the histories part by more than
1e-9 — JAX's own histories at 1 and at 4 shards part there too.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from raptor_tpu.core.matrix import CSRMatrix as JCSRMatrix  # noqa: E402
from raptor_tpu.core.par_matrix import ParCSRMatrix as JParCSR  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.krylov import bicgstab as jbicg  # noqa: E402
from raptor_tpu.krylov import cg as jcg  # noqa: E402
from raptor_tpu.krylov import gmres as jgmres  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.krylov import bicgstab as tbicg  # noqa: E402
from raptor_tpu_torch.krylov import cg as tcg  # noqa: E402
from raptor_tpu_torch.krylov import gmres as tgmres  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)

from _torch_parity import jax_rs, port_hierarchy, rhs, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N = 24
TOL = 1e-8
# name: (module, function, preconditioned, keyword arguments)
SOLVERS = {
    "cg": ("cg", "cg", False, {}),
    "pcg": ("cg", "cg", True, {}),
    "bicgstab": ("bicgstab", "bicgstab", False, {}),
    "seq_inner": ("bicgstab", "seq_inner_bicgstab", False, {}),
    "seq_norm": ("bicgstab", "seq_norm_bicgstab", False, {}),
    "seq_inner_seq_norm": ("bicgstab", "seq_inner_seq_norm_bicgstab", False,
                           {}),
    "pi": ("bicgstab", "pi_bicgstab", False, {}),
    "pre": ("bicgstab", "pre_bicgstab", True, {}),
    "pre_pi": ("bicgstab", "pre_pi_bicgstab", True, {}),
    "gmres": ("gmres", "gmres", False, {"restart": 10}),
    "pgmres": ("gmres", "gmres", True, {"restart": 10}),
}
MODULES = {"cg": (jcg, tcg), "bicgstab": (jbicg, tbicg),
           "gmres": (jgmres, tgmres)}


def _shifted(S, shift):
    """The fine operator plus ``shift`` times the identity, as a
    JAX-package matrix."""
    a = jax_rs(N, S).levels[0].A
    m = a.global_csr.to_scipy()
    return JParCSR(JCSRMatrix.from_scipy(
        (m + shift * sp.identity(m.shape[0])).tocsr()), a.partition)


def _operators(a, S, rng):
    """(mesh, JAX A, [x0, b]) and (port A, [x0, b]) for host matrix ``a``
    with b a seeded standard normal."""
    mesh = jpar.make_mesh(S)
    jA = jpar.device_put_matrix(a, mesh, dtype=jnp.float64,
                                need_transpose=False)
    tA = tpar.device_put_matrix(to_port(a), need_transpose=False,
                                device="cpu")
    bounds = a.partition.row_bounds
    b = rng.standard_normal(a.global_num_rows)
    jv = [jpar.device_put_vector(v, bounds, jA.rows_pad, mesh)
          for v in (np.zeros_like(b), b)]
    tv = [tpar.device_put_vector(v, bounds, tA.rows_pad, device="cpu")
          for v in (np.zeros_like(b), b)]
    return (mesh, jA, jv), (tA, tv)


@functools.lru_cache(maxsize=None)
def _two_level(S):
    jml = jax_rs(N, S, "CLJP", "ModClassical", "Chebyshev", 3, 2)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(S), dtype=jnp.float64,
                             lane_pad=1)
    tdh = DeviceHierarchy(port_hierarchy(jml), dtype=torch.float64,
                          lane_pad=1, device="cpu")
    return jml, jdh, tdh


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_solver_matches_jax(name, S):
    mod, fn, pre, kw = SOLVERS[name]
    jkw = dict(kw, tol=TOL, max_iter=400)
    tkw = dict(jkw)
    if pre:
        jml, jdh, tdh = _two_level(S)
        b = rhs(jml)
        mesh, jA, jv = jdh.mesh, jdh.levels[0].A, [
            jdh.vector(np.zeros_like(b)), jdh.vector(b)]
        tA, tv = tdh.levels[0].A, [tdh.vector(np.zeros_like(b)),
                                   tdh.vector(b)]
        jkw["precond"] = jdh.precond_pack()
        tkw["precond"] = tdh.precond_pack()
    else:
        (mesh, jA, jv), (tA, tv) = _operators(
            _shifted(S, 1.0), S, np.random.default_rng(S))
    jmod, tmod = MODULES[mod]
    jr = getattr(jmod, fn)(mesh, jA, *jv, **jkw)
    tr = getattr(tmod, fn)(tA, *tv, **tkw)
    assert tr.n_iters == int(jr.n_iters) > 1
    jres = np.asarray(jr.res)
    np.testing.assert_allclose(tr.res, jres, rtol=1e-9,
                               atol=1e-16 * abs(jres[0]))
    if "pi" in name and S == 1:
        # one shard: the odd half is empty, and the solve stops on the
        # non-finite residual at its second iteration, as JAX's does
        assert tr.n_iters == 2 and np.isnan(tr.res[2])
        return
    # CG and GMRES hold ||r|| / ||b||, BiCGStab ||r||; x0 = 0, so r0 = b
    assert tr.res[tr.n_iters] <= TOL * tr.res[0]
    bounds = jax_rs(N, S).levels[0].A.partition.row_bounds
    x = tpar.host_vector(tr.x, bounds)
    np.testing.assert_allclose(
        x, jpar.host_vector(np.asarray(jr.x), bounds), rtol=0,
        atol=1e-9 * np.abs(x).max())
    if mod == "cg":
        assert not tr.indefinite and not bool(jr.indefinite)


@pytest.mark.parametrize("S", [1, 4])
def test_cg_indefinite_flag(S):
    """A - 2.5 I is indefinite: both packages' CG raise the flag at the
    same iteration and stop there."""
    (mesh, jA, jv), (tA, tv) = _operators(_shifted(S, -2.5), S,
                                          np.random.default_rng(S))
    jr = jcg.cg(mesh, jA, *jv, tol=1e-10)
    tr = tcg.cg(tA, *tv, tol=1e-10)
    assert tr.indefinite and bool(jr.indefinite)
    assert tr.n_iters == int(jr.n_iters) < 100
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9)


def test_f64_cg_with_f32_precond_reaches_1e11():
    """Mixed-precision PCG: a float64 CG loop on the float64 fine
    operator with the float32 hierarchy's V-cycle as its preconditioner
    (the correction cast back to float64) reaches 1e-11."""
    jml = jax_rs(N, 4, "CLJP", "ModClassical", "Chebyshev", 3)
    tdh = DeviceHierarchy(port_hierarchy(jml), dtype=torch.float32,
                          lane_pad=1, device="cpu")
    A64 = tpar.device_put_matrix(to_port(jml.levels[0].A),
                                 dtype=torch.float64, lane_pad=1,
                                 need_transpose=False, device="cpu")
    b = rhs(jml)
    bounds = jml.levels[0].A.partition.row_bounds

    def vec(v):
        return tpar.device_put_vector(v, bounds, A64.rows_pad,
                                      dtype=torch.float64, device="cpu")

    precond = tdh.precond_pack()
    assert tdh.precond_pack() is precond
    r = tcg.cg(A64, vec(np.zeros_like(b)), vec(b), tol=1e-11, max_iter=60,
               precond=precond)
    assert r.x.dtype == torch.float64
    assert r.res[r.n_iters] <= 1e-11 < r.res[r.n_iters - 1]
    x = tpar.host_vector(r.x, bounds)
    a = jml.levels[0].A.global_csr.to_scipy()
    assert np.linalg.norm(b - a @ x) <= 1e-11 * np.linalg.norm(b)
