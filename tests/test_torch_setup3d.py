"""Parity of the port's 3-D path with the JAX package's: the 27-point
Laplacian with PMIS or HMIS coarsening and extended+i interpolation
(filtered at 0.3), level by level (strength, CF states, P, Galerkin
operators, coarse LU), and the device solve of that hierarchy in float64
and in mixed precision.

JAX runs on the CPU mesh of tests/conftest.py with the host setup engines;
its transfer SpMVs run their XLA versions, the port's run the plain PyTorch
versions of its kernels on CPU tensors.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.matrix import CSRMatrix as JCSR  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu.ruge_stuben import cf_splitting as jcf  # noqa: E402
from raptor_tpu.ruge_stuben import interpolation as jint  # noqa: E402
from raptor_tpu.ruge_stuben import strength as jstr  # noqa: E402
from raptor_tpu.utils import glibc_rand as jrand  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.ruge_stuben import cf_splitting as tcf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import interpolation as tint  # noqa: E402
from raptor_tpu_torch.ruge_stuben import strength as tstr  # noqa: E402

from _torch_parity import (  # noqa: E402
    assert_same_history, assert_same_matrix, jax_hierarchy3d, jax_solve3d,
    rhs, to_port)
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

CASES = [(12, 1), (16, 1), (16, 4)]
COARSENINGS = ["PMIS", "HMIS"]
N_SOLVE = 16


def _port_setup3d(n, S, coarsen="PMIS", interp="Extended"):
    ml = ParRugeStubenSolver(0.25, getattr(CoarsenType, coarsen),
                             getattr(InterpType, interp),
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.setup(tst.par_stencil_grid(tst.laplace_stencil_27pt(), (n, n, n), S))
    return ml


@pytest.mark.parametrize("coarsen", COARSENINGS)
@pytest.mark.parametrize("n,S", CASES)
def test_hierarchy_matches_jax(coarsen, n, S):
    """Level count, sizes, A and P of every level, and the coarse LU."""
    jml = jax_hierarchy3d(n, S, coarsen)
    tml = _port_setup3d(n, S, coarsen)
    assert tml.num_levels == len(jml.levels) >= 3
    for tl, jl in zip(tml.levels, jml.levels):
        assert_same_matrix(tl.A, jl.A)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            assert_same_matrix(tl.P, jl.P)
    np.testing.assert_allclose(tml.coarse_lu[0], jml.coarse_lu[0],
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(tml.coarse_lu[1], jml.coarse_lu[1])


@pytest.mark.parametrize("coarsen", COARSENINGS)
@pytest.mark.parametrize("n,S", CASES)
def test_splitting_and_interpolation_match_jax(coarsen, n, S):
    """On every level's operator: strength, the PMIS/HMIS states, extended+i
    P before the filter and after it."""
    jml = jax_hierarchy3d(n, S, coarsen)
    weights = jrand.form_rand_weights(jml.levels[0].A.global_num_rows, 0)
    jsplit = {"PMIS": jcf.split_pmis, "HMIS": jcf.split_hmis}[coarsen]
    tsplit = {"PMIS": tcf.split_pmis, "HMIS": tcf.split_hmis}[coarsen]
    for jl in jml.levels[:-1]:
        tA = to_port(jl.A)
        js = jstr.strength(jl.A, theta=0.25)
        ts = tstr.strength(tA, theta=0.25)
        assert_same_matrix(ts, js)
        w = weights[:jl.A.global_num_rows]
        jstates, tstates = jsplit(js, w), tsplit(ts, w)
        np.testing.assert_array_equal(tstates, jstates)
        jp = jint.par_interpolation(jl.A, js, jstates, "extended")
        tp = tint.par_interpolation(tA, ts, tstates, "extended")
        assert_same_matrix(tp, jp)
        for thr in (0.3, 0.0):
            jf = jint.filter_interp(jp.global_csr, thr)
            tf = tint.filter_interp(tp.global_csr, thr)
            for f in ("indptr", "indices", "data"):
                np.testing.assert_array_equal(getattr(tf, f),
                                              getattr(jf, f))


@pytest.mark.parametrize("thr", [0.0, 0.3, 0.7, 1.0])
def test_filter_interp_matches_jax(thr):
    """The row-sum-preserving filter alone, on a random P-shaped matrix
    with mixed signs, rows whose kept entries sum to zero, and empty rows:
    the same entries, bit for bit."""
    rng = np.random.default_rng(4)
    m = sp.random(300, 60, density=0.08, random_state=6, format="csr")
    m.data = rng.standard_normal(m.nnz)
    m = m.tolil()
    m[7, :] = 0
    m[11, :] = 0
    m[11, 3], m[11, 4] = 1.0, -1.0
    m = m.tocsr()
    m.sort_indices()
    args = (m.shape[0], m.shape[1], m.indptr.astype(np.int64),
            m.indices.astype(np.int64), m.data)
    jf = jint.filter_interp(JCSR(*args), thr)
    tf = tint.filter_interp(TCSR(*args), thr)
    for f in ("indptr", "indices", "data"):
        assert getattr(tf, f).tobytes() == getattr(jf, f).tobytes(), f
    if thr > 0:
        # the filter keeps row sums
        np.testing.assert_allclose(
            tf.to_scipy().sum(axis=1), m.sum(axis=1), rtol=1e-12,
            atol=1e-12)


@pytest.mark.parametrize("coarsen,interp", [("RS", "Extended"),
                                            ("PMIS", "ModClassical"),
                                            ("HMIS", "ModClassical")])
def test_other_pairings_match_jax(coarsen, interp):
    """The coarsenings and interpolations combine freely, as in JAX."""
    from raptor_tpu.core.types import CoarsenType as JC
    from raptor_tpu.core.types import InterpType as JI
    from raptor_tpu.core.types import RelaxType as JR
    from raptor_tpu.gallery.stencils import (laplace_stencil_27pt,
                                             par_stencil_grid)
    from raptor_tpu.multilevel.par_multilevel import (
        ParRugeStubenSolver as JaxSolver)
    jml = JaxSolver(0.25, getattr(JC, coarsen), getattr(JI, interp),
                    relax_type=JR.Chebyshev)
    jml.rap_mode = jml.interp_mode = "host"
    jml.setup(par_stencil_grid(laplace_stencil_27pt(), (12, 12, 12), 2))
    tml = _port_setup3d(12, 2, coarsen, interp)
    assert tml.num_levels == len(jml.levels)
    for tl, jl in zip(tml.levels, jml.levels):
        assert_same_matrix(tl.A, jl.A)


@pytest.mark.parametrize("S,lane_pad", [(4, 1)])
def test_solve_histories_match_jax(S, lane_pad):
    """f64 V-cycle solves to 1e-9 on the port's own 3-D setup, over four
    shards: JAX's cycles and residual history on its setup
    (tests/test_torch_transfer.py solves one shard at lane_pad 128)."""
    tml = _port_setup3d(N_SOLVE, S)
    b = rhs(tml)
    tdh = DeviceHierarchy(tml, dtype=torch.float64, lane_pad=lane_pad,
                          device="cpu")
    tdh.solve_tol = 1e-9
    tr = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b))
    assert_same_history(tr, jax_solve3d(N_SOLVE, S, lane_pad))


def test_solve_mixed_matches_jax():
    """Mixed-precision refinement on an f32 hierarchy with b = A 1 (the
    right-hand side of the JAX package's 3-D record): both reach 1e-8,
    within one refinement of each other."""
    S = 4
    jml = jax_hierarchy3d(N_SOLVE, S)
    tml = _port_setup3d(N_SOLVE, S)
    b = rhs(tml, ones=True)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(S), dtype=jnp.float32)
    tdh = DeviceHierarchy(tml, dtype=torch.float32, lane_pad=1,
                          device="cpu")
    _, jhist = jdh.solve_mixed(np.zeros_like(b), b, tol=1e-8)
    tx, thist = tdh.solve_mixed(np.zeros_like(b), b, tol=1e-8)
    assert jhist[-1] <= 1e-8 and thist[-1] <= 1e-8
    assert abs(len(thist) - len(jhist)) <= 1
    a = tml.levels[0].A.global_csr.to_scipy()
    assert np.linalg.norm(b - a @ tx) <= 1e-8 * np.linalg.norm(b)
