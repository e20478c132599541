"""The blocked (BSR) containers, the finite-element gallery and the blocked
device matrix of the port against the JAX package: ``BSRMatrix``,
``gallery.fem`` (Q1 Laplacian, plane-stress elasticity, ``par_fem``) and
``device.bsr`` (``device_put_bsr``'s arrays bit for bit, ``bsr_spmv`` in
float64). The block matrices are tests/test_bsr.py's: the 27-point
Laplacian on an 8^3 grid in 2 x 2 and 4 x 4 blocks, at 1, 4 and 8 shards.
JAX runs on the CPU mesh of tests/conftest.py; the port on CPU tensors.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.core.matrix import BSRMatrix as JBSRMatrix  # noqa: E402
from raptor_tpu.core.par_matrix import par_matrix_from_scipy  # noqa: E402
from raptor_tpu.device import bsr as jbsr  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import fem as jfem  # noqa: E402
from raptor_tpu.gallery.stencils import (  # noqa: E402
    laplace_stencil_27pt, stencil_grid)
from raptor_tpu_torch.core.matrix import BSRMatrix, CSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.device import bsr as tbsr  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery import fem as tfem  # noqa: E402

from _torch_parity import to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

DATA = jbsr._BSR_DATA
META = jbsr._BSR_META


@functools.lru_cache(maxsize=None)
def _lap27():
    """The JAX package's 27-point Laplacian on 8^3 (tests/test_bsr.py)."""
    return stencil_grid(laplace_stencil_27pt(), (8, 8, 8))


def _port_csr(j):
    return CSRMatrix(j.n_rows, j.n_cols, j.indptr.copy(), j.indices.copy(),
                     j.data.copy())


def _bits(t, j):
    """Two numpy arrays equal bit for bit, dtype aside for integers."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.shape == j.shape
    if j.dtype.kind == "f":
        assert t.astype(j.dtype).tobytes() == j.tobytes()
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("bs", [2, 4])
def test_bsr_matrix_matches_jax(bs):
    """from_csr / to_csr fields bit-equal to JAX's; the block counts, nnz
    and the host products."""
    j = _lap27()
    jb = JBSRMatrix.from_csr(j, bs, bs)
    tb = BSRMatrix.from_csr(_port_csr(j), bs, bs)
    for f in ("n_rows", "n_cols", "b_rows", "b_cols", "n_block_rows",
              "n_block_cols", "nnz"):
        assert getattr(tb, f) == getattr(jb, f)
    for f in ("indptr", "indices", "blocks"):
        _bits(getattr(tb, f), getattr(jb, f))
    tc, jc = tb.to_csr(), jb.to_csr()
    for f in ("indptr", "indices", "data"):
        _bits(getattr(tc, f), getattr(jc, f))
    # the blocks' explicit zeros stay stored; the values round-trip
    np.testing.assert_array_equal(tc.to_scipy().toarray(),
                                  j.to_scipy().toarray())
    x = np.random.default_rng(1).standard_normal(j.n_cols)
    np.testing.assert_array_equal(tb.mult(x), jb.mult(x))
    np.testing.assert_array_equal(tb.mult_T(x), jb.mult_T(x))
    np.testing.assert_allclose(tb.mult(x), j.mult(x), rtol=0, atol=1e-12)


@pytest.mark.parametrize("nx,ny", [(16, 8), (24, 12)])
def test_fem_gallery_bit_equal_to_jax(nx, ny):
    """q1_laplacian, and q1_linear_elasticity's K and variables."""
    for t, j in ((tfem.q1_laplacian(nx, ny), jfem.q1_laplacian(nx, ny)),
                 (tfem.q1_linear_elasticity(nx, ny)[0],
                  jfem.q1_linear_elasticity(nx, ny)[0])):
        assert t.shape == (j.n_rows, j.n_cols)
        for f in ("indptr", "indices", "data"):
            _bits(getattr(t, f), getattr(j, f))
    tv = tfem.q1_linear_elasticity(nx, ny)[1]
    jv = jfem.q1_linear_elasticity(nx, ny)[1]
    assert tv.dtype == jv.dtype
    np.testing.assert_array_equal(tv, jv)
    # a different material is assembled the same way too
    t = tfem.q1_linear_elasticity(nx, ny, E=2.5, nu=0.25)[0]
    j = jfem.q1_linear_elasticity(nx, ny, E=2.5, nu=0.25)[0]
    _bits(t.data, j.data)


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("kind", ["laplace", "elasticity"])
def test_par_fem_partitions_match_jax(kind, n_shards):
    t = tfem.par_fem(kind, 24, 12, n_shards)
    j = jfem.par_fem(kind, 24, 12, n_shards)
    if kind == "elasticity":
        (t, tv), (j, jv) = t, j
        np.testing.assert_array_equal(tv, jv)
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(t.partition, f),
                                      getattr(j.partition, f))
    _bits(t.global_csr.data, j.global_csr.data)
    np.testing.assert_array_equal(t.global_csr.indices, j.global_csr.indices)


@pytest.mark.parametrize("kind", ["dg_diffusion", "dg_elasticity",
                                  "grad_div", "adaptive_laplacian"])
def test_par_fem_dg_kinds_raise(kind):
    """The DG and vector kinds build through ``par_fem`` bit-equal to the
    JAX package's (gallery/dg.py is ported); an unknown kind raises."""
    t = tfem.par_fem(kind, 8, 8, 2)
    j = jfem.par_fem(kind, 8, 8, 2)
    if kind == "dg_elasticity":
        (t, tv), (j, jv) = t, j
        np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(t.partition.row_bounds,
                                  j.partition.row_bounds)
    np.testing.assert_array_equal(t.global_csr.indptr, j.global_csr.indptr)
    np.testing.assert_array_equal(t.global_csr.indices,
                                  j.global_csr.indices)
    _bits(t.global_csr.data, j.global_csr.data)
    with pytest.raises(ValueError):
        tfem.par_fem("no_such_kind", 8, 8, 1)


@functools.lru_cache(maxsize=None)
def _packed(n_shards, bs):
    """(JAX's, the port's) device_put_bsr of the 27-point Laplacian."""
    j = par_matrix_from_scipy(_lap27().to_scipy(), n_shards)
    jB = jbsr.device_put_bsr(j, bs, bs, jpar.make_mesh(n_shards))
    tB = tbsr.device_put_bsr(to_port(j), bs, bs, device="cpu")
    return jB, tB


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("bs", [2, 4])
def test_device_put_bsr_arrays_equal_jax(n_shards, bs):
    jB, tB = _packed(n_shards, bs)
    for f in META:
        assert getattr(tB, f) == getattr(jB, f), f
    for f in DATA:
        _bits(getattr(tB, f).numpy(), getattr(jB, f))
    assert tB.on_blocks.dtype == torch.float64
    assert tB.off_rows.dtype == torch.int64


def _random_x(B, n_shards, bs, seed=3):
    """A random global x and its [S, bcols_pad * bs] layout."""
    n = B.global_num_cols
    xh = np.random.default_rng(seed).standard_normal(n)
    cb = Partition.create(n // bs, n // bs, n_shards).col_bounds * bs
    return xh, cb


@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("bs", [2, 4])
def test_bsr_spmv_matches_jax(n_shards, bs):
    """float64 to 1e-12 against JAX's bsr_spmv and the host product."""
    jB, tB = _packed(n_shards, bs)
    assert (tB.off_cols.shape[-1] > 0) == (n_shards > 1)
    xh, cb = _random_x(tB, n_shards, bs)
    pad = tB.bcols_pad * bs
    mesh = jpar.make_mesh(n_shards)
    jy = np.asarray(jbsr.bsr_spmv(
        mesh, jB, jpar.device_put_vector(xh, cb, pad, mesh)))
    ty = tbsr.bsr_spmv(tB, tpar.device_put_vector(xh, cb, pad,
                                                  device="cpu"))
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty.numpy(), jy, rtol=0,
                               atol=1e-12 * np.abs(jy).max())
    np.testing.assert_allclose(tpar.host_vector(ty, cb), _lap27().mult(xh),
                               rtol=0, atol=1e-12 * np.abs(jy).max())
    # the padding of the output stays zero
    rb = np.diff(cb) // bs
    for s in range(n_shards):
        assert not ty[s, rb[s] * bs:].any()


@pytest.mark.parametrize("n_shards", [1, 4, 8])
def test_bsr_spmv_elasticity_matches_jax(n_shards):
    """The 2 x 2 blocked 24 x 12 elasticity operator, float64 against JAX's
    bsr_spmv to 1e-12 and float32 against the scalar host product to 1e-5.
    At 4 and 8 shards the end shards have fewer boundary block rows than
    BB, so their off_rows padding (block row RB, out of bounds) is
    scattered and dropped."""
    A, _ = tfem.par_fem("elasticity", 24, 12, n_shards)
    jA, _ = jfem.par_fem("elasticity", 24, 12, n_shards)
    mesh = jpar.make_mesh(n_shards)
    jB = jbsr.device_put_bsr(jA, 2, 2, mesh)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        B = tbsr.device_put_bsr(A, 2, 2, dtype=dtype, device="cpu")
        assert B.on_blocks.dtype == dtype
        if n_shards > 1:
            assert (B.off_rows == B.brows_pad).any(dim=1).sum() >= 2
        xh, cb = _random_x(B, n_shards, 2, seed=5)
        pad = B.bcols_pad * 2
        y = tbsr.bsr_spmv(B, tpar.device_put_vector(
            xh, cb, pad, dtype=dtype, device="cpu"))
        ref = A.mult(xh)
        np.testing.assert_allclose(tpar.host_vector(y, cb), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())
        if dtype == torch.float64:
            jy = np.asarray(jbsr.bsr_spmv(
                mesh, jB, jpar.device_put_vector(xh, cb, pad, mesh)))
            np.testing.assert_allclose(y.numpy(), jy, rtol=0,
                                       atol=1e-12 * np.abs(jy).max())


def test_device_put_bsr_rejects_partial_blocks():
    j = par_matrix_from_scipy(_lap27().to_scipy(), 1)
    with pytest.raises(ValueError, match="blocks"):
        tbsr.device_put_bsr(to_port(j), 3, 3, device="cpu")
