"""The port's DG and vector FE gallery (``gallery/dg.py``, vectorised over
elements and faces) against the JAX package's loops: every kind at the
sizes of tests/test_fem.py (and ``dg_diffusion`` at 32 x 32) with the
same pattern and values within 1e-13 of max |A| (they are equal bit for
bit today: the triplets come in the JAX package's order), and
tests/test_fem.py::test_fem_gallery_amg_solves's three AMG-PCG solves
(RS + modified classical, theta 0.25, Chebyshev(2), float64, 4 shards) in
the JAX package's iterations, with the residual histories within 1e-6
(up to 67 iterations of CG take up the rounding of the two packages'
sums) and x within 1e-10 of max |x|. The grad-div solve, whose JAX
compile takes longest, is in tests/test_torch_dg_solve.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.types import CoarsenType as JC  # noqa: E402
from raptor_tpu.core.types import InterpType as JI  # noqa: E402
from raptor_tpu.core.types import RelaxType as JR  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.krylov.cg import cg as jcg  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu_torch.core.types import CoarsenType, InterpType  # noqa: E402
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.krylov.cg import cg  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

VALUE_TOL = 1e-13     # of max |A|: the sums may add duplicates in turn


def _matrix(out):
    return out[0] if isinstance(out, tuple) else out


KINDS = ("dg_diffusion", "dg_elasticity", "grad_div", "adaptive_laplacian")


@pytest.mark.parametrize("kind,shape", [
    (k, s) for k in KINDS for s in ((10, 8), (8, 6), (12, 10), (16, 1))]
    + [("dg_diffusion", (32, 32))])
def test_dg_gallery_matches_jax(kind, shape):
    """Every kind at each size of tests/test_fem.py (one element row
    included: 16 x 1 has no inner faces normal to y), on 3 shards."""
    t = par_fem(kind, *shape, 3)
    j = jpar_fem(kind, *shape, 3)
    if kind == "dg_elasticity":
        np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(_matrix(t).partition.row_bounds,
                                  _matrix(j).partition.row_bounds)
    t, j = _matrix(t).global_csr, _matrix(j).global_csr
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_allclose(t.data, j.data, rtol=0,
                               atol=VALUE_TOL * np.abs(j.data).max())


def _port_pcg(A, b):
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    dh = DeviceHierarchy(ml, dtype=torch.float64, device="cpu")
    dA = tpar.device_put_matrix(A, dtype=torch.float64,
                                need_transpose=False, device="cpu")

    def vec(v):
        return tpar.device_put_vector(v, A.partition.row_bounds,
                                      dA.rows_pad, device="cpu")
    r = cg(dA, vec(np.zeros_like(b)), vec(b), tol=1e-8, max_iter=200,
           precond=dh.precond_pack())
    return ml, r, tpar.host_vector(r.x, A.partition.row_bounds)


def _jax_pcg(A, b):
    ml = JRS(0.25, JC.RS, JI.ModClassical, relax_type=JR.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    mesh = jpar.make_mesh(4)
    dh = JDH(ml, mesh, dtype=jnp.float64)
    dA = jpar.device_put_matrix(A, mesh, need_transpose=False)

    def vec(v):
        return jpar.device_put_vector(v, A.partition.row_bounds,
                                      dA.rows_pad, mesh)
    r = jcg(mesh, dA, vec(np.zeros_like(b)), vec(b), tol=1e-8,
            max_iter=200, precond=dh.precond_pack())
    return ml, r, jpar.host_vector(np.asarray(r.x), A.partition.row_bounds)


def check_amg_pcg(kind, shape):
    tA = _matrix(par_fem(kind, *shape, 4))
    jA = _matrix(jpar_fem(kind, *shape, 4))
    b = jA.mult(np.ones(jA.global_num_rows))
    tml, tr, tx = _port_pcg(tA, b)
    jml, jr, jx = _jax_pcg(jA, b)
    assert ([lvl.A.nnz for lvl in tml.levels]
            == [lvl.A.nnz for lvl in jml.levels])
    k = int(jr.n_iters)
    assert tr.n_iters == k < 120
    assert tr.res[k] < 1e-8
    np.testing.assert_allclose(tr.res[:k + 1], np.asarray(jr.res)[:k + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


@pytest.mark.parametrize("kind,shape", [
    ("dg_diffusion", (12, 10)), ("adaptive_laplacian", (16, 1))])
def test_gallery_amg_pcg_matches_jax(kind, shape):
    check_amg_pcg(kind, shape)
