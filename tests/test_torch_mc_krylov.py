"""The Krylov solvers across controllers: CG, every BiCGStab variant and
restarted GMRES, plain and AMG-preconditioned, with one controller per
shard, against the JAX package's solvers and the port's stacked route.

``launch.run_controllers`` starts 2 and 4 gloo controllers on the CPU.
Each builds only its own rows of the 24^2 rotated anisotropic problem,
sets up a two-level float64 Chebyshev hierarchy by ``spmd_rs_setup``
(HMIS + extended+i) over its ``SocketGroup`` and ``from_spmd(...,
comm=comm)``, and runs every entry of tests/test_torch_krylov.py:SOLVERS
from zero to 1e-8 (``tests/_torch_mc.py:krylov``): the preconditioned
ones on the fine operator with b = A 1 and the hierarchy's
``precond_pack()``, the plain ones on the fine operator plus the identity
(as tests/test_torch_krylov.py runs them) with a seeded b. Two levels
keep JAX's compiles short.

Each controller's iteration count must be the JAX package's for the same
solver on its in-process ``from_spmd`` hierarchy (or its packed A + I),
its rows of x within 1e-10 of max |x| of JAX's, and the history within
rtol 1e-10 or 1e-14 of the first residual (PI-BiCGStab's scaled half
inner products at 2 shards leave its last residuals, 1e-8 of the first,
1.8e-14 apart from JAX's: rounding of the per-shard dots, which XLA and
torch sum in their own orders); and its rows and history within 1e-14 of the
port's stacked route on the same shards: the inner products gather the
per-shard partials into shard order and reduce them as the stacked route
does (the sequential modes sum them in shard order), so only the
per-shard row sums may round differently.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from raptor_tpu.comm.spmd import spmd_rs_setup as jspmd_rs  # noqa: E402
from raptor_tpu.comm.transport import (  # noqa: E402
    InProcessTransport as JIT)
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.core.matrix import CSRMatrix as JCSRMatrix  # noqa: E402
from raptor_tpu.core.par_matrix import ParCSRMatrix as JParCSR  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu_torch.comm import launch  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

import _torch_mc  # noqa: E402
from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401
from test_torch_krylov import MODULES, SOLVERS  # noqa: E402

N = 24
LEVELS = 2
TOL = 1e-8
MAX_ITER = 400


@functools.lru_cache(maxsize=None)
def _controllers(world):
    return launch.run_controllers(
        world, "_torch_mc:krylov", (N, LEVELS, SOLVERS, TOL, MAX_ITER),
        device="cpu", timeout=300)


@functools.lru_cache(maxsize=None)
def _stacked(world):
    """Every solver on the port's stacked route (every shard on the CPU):
    {name: (x, history, iterations)} and the row bounds."""
    dh, A1, b_ones, b_rand, rb = _torch_mc.krylov_problem(N, world, None,
                                                          LEVELS)
    out = {}
    for name, (mod, fn, pre, kw) in SOLVERS.items():
        A, b = (dh.levels[0].A, b_ones) if pre else (A1, b_rand)
        if pre:
            kw = dict(kw, precond=dh.precond_pack())
        v = [tpar.device_put_vector(u, rb, A.rows_pad, device="cpu")
             for u in (np.zeros_like(b), b)]
        r = getattr(MODULES[mod][1], fn)(A, *v, tol=TOL, max_iter=MAX_ITER,
                                         **kw)
        out[name] = (tpar.host_vector(r.x, rb), r.res, r.n_iters)
    return out, rb


@functools.lru_cache(maxsize=None)
def _jax_problem(world):
    """The JAX package's in-process ``from_spmd`` hierarchy (two levels,
    float64 Chebyshev), its packed A + I, b = A 1 and the seeded b."""
    A = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (N, N),
                             world)
    hier = jspmd_rs(A, form_rand_weights(N * N, 0), JIT,
                    coarsen=jt.CoarsenType.HMIS,
                    interp=jt.InterpType.Extended, max_levels=LEVELS)
    mesh = jpar.make_mesh(world)
    dh = JDH.from_spmd(hier, mesh, JIT, relax_type=jt.RelaxType.Chebyshev)
    m = A.global_csr.to_scipy()
    A1 = jpar.device_put_matrix(
        JParCSR(JCSRMatrix.from_scipy((m + sp.identity(m.shape[0])).tocsr()),
                A.partition), mesh, dtype=jnp.float64, need_transpose=False)
    b_rand = np.random.default_rng(world).standard_normal(N * N)
    return mesh, dh, A1, A.mult(np.ones(N * N)), b_rand, A.partition


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    mod, fn, pre, kw = SOLVERS[name]
    mesh, dh, A1, b_ones, b_rand, part = _jax_problem(world)
    A, b = (dh.levels[0].A, b_ones) if pre else (A1, b_rand)
    if pre:
        kw = dict(kw, precond=dh.precond_pack())
    v = [jpar.device_put_vector(u, part.row_bounds, A.rows_pad, mesh)
         for u in (np.zeros_like(b), b)]
    r = getattr(MODULES[mod][0], fn)(mesh, A, *v, tol=TOL,
                                     max_iter=MAX_ITER, **kw)
    return (jpar.host_vector(np.asarray(r.x), part.row_bounds),
            np.asarray(r.res), int(r.n_iters))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_mc_krylov_matches_jax(name, world):
    """Each controller takes the JAX package's iterations, its rows of x
    are JAX's within 1e-10 of max |x|, the history within rtol 1e-10 or
    1e-14 of the first residual."""
    x_ref, res_ref, n_ref = _jax(world, name)
    rb = _stacked(world)[1]
    for r, out in enumerate(_controllers(world)):
        got = out[name]
        assert out["rank"] == r and out["r0"] == rb[r]
        assert got["n_iters"] == n_ref > 1
        np.testing.assert_allclose(got["res"], res_ref, rtol=1e-10,
                                   atol=1e-14 * abs(res_ref[0]))
        # CG and GMRES hold ||r|| / ||b||, BiCGStab ||r||; x0 = 0
        assert got["res"][n_ref] <= TOL * got["res"][0]
        np.testing.assert_allclose(got["x"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=0,
                                   atol=1e-10 * np.abs(x_ref).max())


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(SOLVERS))
def test_mc_krylov_matches_stacked(name, world):
    """Each controller's iterations are the stacked route's, its rows of x
    and the history within 1e-14 of it (of max |x|, of the first
    residual)."""
    ref, rb = _stacked(world)
    x_ref, res_ref, n_ref = ref[name]
    for r, out in enumerate(_controllers(world)):
        got = out[name]
        assert got["n_iters"] == n_ref
        np.testing.assert_allclose(got["res"], res_ref, rtol=0,
                                   atol=1e-14 * abs(res_ref[0]))
        np.testing.assert_allclose(got["x"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=0,
                                   atol=1e-14 * np.abs(x_ref).max())
