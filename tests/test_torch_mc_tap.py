"""The topology-aware (TAP) exchange across controllers: the port of the JAX
package's tests/test_multicontroller.py::test_multicontroller_tap_mesh.

``launch.run_controllers`` starts 4 gloo controllers on the CPU, laid out
as 2 hosts x 2 (``make_mesh2(2, 2)``). Each builds only its own rows of
the 24^2 rotated anisotropic problem, runs ``spmd_rs_setup`` (HMIS +
extended+i) over its ``SocketGroup`` and joins a float64 Chebyshev solve
from ``from_spmd(..., tap_amg=t, comm=comm)`` with t = 0 and 1, whose
TAP exchanges are all-to-alls over the comm's host and local sub-groups
(``DeviceComm.mesh2``; ``tests/_torch_mc.py:tap_solve``). Each rank's
rows, history and cycle count must match the JAX oracle
(tests/test_multicontroller.py:_oracle(4), the plain in-process solve) at
the JAX test's rtol 1e-8 / atol 1e-12 with equal counts (TAP's gateway
staging reorders the transpose sums), and the port's stacked TAP route
(``from_spmd`` on ``make_mesh2(2, 2)`` with every shard on the CPU) to
1e-14 of max |x|: the two routes run the same arithmetic.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.comm import launch  # noqa: E402
from raptor_tpu_torch.comm.spmd import spmd_rs_setup  # noqa: E402
from raptor_tpu_torch.comm.transport import (  # noqa: E402
    InProcessTransport as TIT)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.device.par import make_mesh2  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as TDH)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401
from test_multicontroller import _oracle  # noqa: E402

N = 24
WORLD = 4
LAYOUT = (2, 2)
TAP_AMGS = (0, 1)


@functools.lru_cache(maxsize=None)
def _controllers():
    return launch.run_controllers(WORLD, "_torch_mc:tap_solve",
                                  (N, LAYOUT, TAP_AMGS), device="cpu",
                                  timeout=300)


@functools.lru_cache(maxsize=None)
def _stacked(tap_amg):
    """The port's stacked TAP route on the same shards: its whole solution,
    history, cycle count and row bounds."""
    A = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (N, N),
                             WORLD)
    hier = spmd_rs_setup(A, form_rand_weights(N * N, 0), TIT,
                         coarsen=tt.CoarsenType.HMIS,
                         interp=tt.InterpType.Extended)
    dh = TDH.from_spmd(hier, TIT, relax_type=tt.RelaxType.Chebyshev,
                       device="cpu", mesh=make_mesh2(*LAYOUT),
                       tap_amg=tap_amg)
    b = A.mult(np.ones(N * N))
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    return (dh.host(r.x), r.res[r.res >= 0.0], r.n_iters,
            np.asarray(A.partition.row_bounds))


@pytest.mark.parametrize("tap_amg", TAP_AMGS)
def test_mc_tap_matches_jax_oracle(tap_amg):
    """Every controller's rows, history and cycle count are the JAX
    oracle's (rtol 1e-8, atol 1e-12, equal counts), with TAP on the
    levels from ``tap_amg`` down."""
    x_ref, hist_ref, n_iters = _oracle(WORLD)
    rb = _stacked(tap_amg)[3]
    for r, out in enumerate(_controllers()):
        got = out[tap_amg]
        assert out["rank"] == r and out["r0"] == rb[r]
        assert got["tap_levels"][tap_amg:] == [True] * (
            len(got["tap_levels"]) - tap_amg)
        assert not any(got["tap_levels"][:tap_amg])
        assert got["n_iters"] == n_iters > 3
        np.testing.assert_allclose(got["hist"], hist_ref, rtol=1e-8,
                                   atol=1e-12)
        np.testing.assert_allclose(got["x"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("tap_amg", TAP_AMGS)
def test_mc_tap_matches_stacked_tap(tap_amg):
    """Every controller's rows and history are the port's stacked TAP
    route's to 1e-14 of max |x| (and of the first residual), with its
    cycle count."""
    x_ref, hist_ref, n_iters, rb = _stacked(tap_amg)
    scale = np.abs(x_ref).max()
    for r, out in enumerate(_controllers()):
        got = out[tap_amg]
        assert got["n_iters"] == n_iters
        np.testing.assert_allclose(got["hist"], hist_ref, rtol=0,
                                   atol=1e-14 * hist_ref[0])
        np.testing.assert_allclose(got["x"], x_ref[rb[r]:rb[r + 1]],
                                   rtol=0, atol=1e-14 * scale)
