"""The port's multi-controller bridge against the JAX package's oracle:
the case of tests/test_multicontroller.py, run by the port's own launcher.

``launch.run_controllers`` starts 2 and 4 gloo controllers on the CPU.
Each builds only its own rows of the 24^2 rotated anisotropic problem,
runs ``spmd_rs_setup`` (HMIS + extended+i) over its ``SocketGroup``,
packs its shard with ``DeviceHierarchy.from_spmd(..., comm=comm)`` and
joins one float64 Chebyshev solve whose halo exchanges, norms and coarse
gather are ``torch.distributed`` collectives (``tests/_torch_mc.py:
bridge``). Each rank's solution rows, residual history and cycle count
must match the JAX package's in-process oracle
(tests/test_multicontroller.py:65-90) to rtol 1e-12, with equal cycle
counts. The same controllers refine a float32 Chebyshev(3) hierarchy to
1e-8 with float64 residuals, which must take the refinements of the
port's in-process route. What the controllers do not run raises: the
blocked solve of a one-shard view (the JAX package packs only global
blocked operators too), and ``from_spmd`` of a one-shard view without the
controllers' comm. TAP and the Krylov solvers across controllers are
tests/test_torch_mc_tap.py and tests/test_torch_mc_krylov.py.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.comm.spmd import spmd_rs_setup as jspmd_rs  # noqa: E402
from raptor_tpu.comm.transport import (  # noqa: E402
    InProcessTransport as JIT)
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu_torch.comm import launch  # noqa: E402
from raptor_tpu_torch.comm.spmd import (  # noqa: E402
    SpmdHierarchy, SpmdLevel, spmd_rs_setup)
from raptor_tpu_torch.comm.transport import (  # noqa: E402
    InProcessTransport as TIT)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.bsr_hierarchy import (  # noqa: E402
    BSRDeviceHierarchy)
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as TDH)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

import _torch_mc  # noqa: E402
from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N = 24


@functools.lru_cache(maxsize=None)
def _controllers(world):
    return launch.run_controllers(world, "_torch_mc:bridge", (N,),
                                  device="cpu", timeout=300)


@functools.lru_cache(maxsize=None)
def _jax_oracle(world):
    """The JAX package's in-process route (tests/test_multicontroller.py:
    _oracle): its whole solution, history and cycle count."""
    A = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (N, N),
                             world)
    hier = jspmd_rs(A, form_rand_weights(N * N, 0), JIT,
                    coarsen=jt.CoarsenType.HMIS,
                    interp=jt.InterpType.Extended)
    dh = JDH.from_spmd(hier, jpar.make_mesh(world), JIT,
                       relax_type=jt.RelaxType.Chebyshev)
    b = A.mult(np.ones(N * N))
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    hist = np.asarray(r.res)
    return (dh.host(np.asarray(r.x)), hist[hist >= 0.0], int(r.n_iters),
            np.asarray(A.partition.row_bounds))


@pytest.mark.parametrize("world", [2, 4])
def test_multicontroller_bridge_matches_jax(world):
    """Every controller's rows, history and cycle count are the JAX
    oracle's (rtol 1e-12, equal counts)."""
    x_ref, hist_ref, n_iters, rb = _jax_oracle(world)
    for r, out in enumerate(_controllers(world)):
        assert out["rank"] == r and out["r0"] == rb[r]
        assert out["n_iters"] == n_iters > 3
        np.testing.assert_allclose(out["hist"], hist_ref, rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_allclose(out["x"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("world", [2, 4])
def test_multicontroller_mixed_refinement_matches_in_process(world):
    """A float32 Chebyshev(3) hierarchy refined with float64 residuals to
    1e-8 across controllers: the in-process route's (the port's
    ``from_spmd`` on every shard) refinements and level sizes, each
    controller's rows of its solution to 1e-14 of max |x| and its history
    to 1e-14: the cycles run the same arithmetic, and only the norms sum
    the shards' dots in another order (over gloo), a few ulp."""
    A = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (N, N),
                             world)
    hier = spmd_rs_setup(A, form_rand_weights(N * N, 0), TIT,
                         coarsen=tt.CoarsenType.HMIS,
                         interp=tt.InterpType.Extended)
    dh = TDH.from_spmd(hier, TIT, relax_type=tt.RelaxType.Chebyshev,
                       num_smooth_sweeps=3, dtype=torch.float32,
                       device="cpu")
    b = A.mult(np.ones(N * N))
    x_ref, hist_ref = dh.solve_mixed(np.zeros_like(b), b, tol=1e-8)
    assert hist_ref[-1] < 1e-8
    rb = A.partition.row_bounds
    for r, out in enumerate(_controllers(world)):
        assert len(out["hist_mixed"]) == len(hist_ref)
        np.testing.assert_allclose(out["hist_mixed"], hist_ref, rtol=1e-14)
        np.testing.assert_allclose(out["x_mixed"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=0,
                                   atol=1e-14 * np.abs(x_ref).max())
        assert out["levels"] == [lvl.A.global_num_rows
                                 for lvl in dh.levels]


def test_multicontroller_raises_for_what_it_does_not_run():
    """The blocked solve of a one-shard view raises, naming the JAX
    package's global-only blocked packing; ``from_spmd`` of a one-shard
    view without the controllers' comm raises."""
    view, _ = _torch_mc.aniso_view(N, 2, 1)
    with pytest.raises(NotImplementedError,
                       match="as the JAX package's BSRDeviceHierarchy"):
        BSRDeviceHierarchy(SimpleNamespace(levels=[SimpleNamespace(A=view)],
                                           tap_amg=-1), device="cpu")
    hier = SpmdHierarchy([SpmdLevel(view, None, None)], (None, None))
    with pytest.raises(ValueError, match="pass their comm"):
        TDH.from_spmd(hier, TIT, device="cpu")
