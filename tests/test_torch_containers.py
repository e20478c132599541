"""The port's containers against the JAX package's: the serial formats of
``core.matrix`` (CSR's ``mult_T`` / ``residual`` / ``add`` / ``subtract`` /
``canonicalize(drop_tol=)``, COO, CSC, BCOO, BSC and ``compare``) and the
row-partitioned ones of ``core.par_matrix`` (ParCSR's ``mult_T`` /
``residual`` / ``add`` / ``subtract``, ParCOO, ParCSC, ParBSR, ParBCOO,
ParBSC) in both storage modes, the local views over the in-process
transport. The same seeded inputs go through both packages; every array
must be bit-equal, dtype included, and ``ParBSRMatrix.to_device`` +
``bsr_spmv`` JAX's on its CPU mesh to 1e-13. The matrices are
tests/test_par_containers.py's: the 2-D anisotropic stencil and the Q1
plane-stress elasticity, and seeded random triplets with duplicates.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu.core import matrix as jm  # noqa: E402
from raptor_tpu.core import par_matrix as jpm  # noqa: E402
from raptor_tpu.core.partition import Partition as JPartition  # noqa: E402
from raptor_tpu.device import bsr as jbsr  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import fem as jfem  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu_torch.core import matrix as tm  # noqa: E402
from raptor_tpu_torch.core import par_matrix as tpm  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.device import bsr as tbsr  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery import fem as tfem  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

SHARDS = [1, 4]


def _bits(t, j):
    """Two arrays equal bit for bit, dtype and shape included."""
    t, j = np.asarray(t), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype)
    assert t.tobytes() == j.tobytes()


def _same(t, j, fields):
    for f in fields:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(b, np.ndarray):
            _bits(a, b)
        else:
            assert a == b, f


CSR = ("n_rows", "n_cols", "indptr", "indices", "data")
BSR = ("n_rows", "n_cols", "b_rows", "b_cols", "indptr", "indices",
       "blocks")


def _triplets(n_rows, n_cols, nnz, seed):
    """Seeded (rows, cols, vals) with duplicates, explicit zeros and
    values of both signs, in a scrambled order."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.standard_normal(nnz)
    vals[::11] = 0.0
    return rows, cols, vals


def _csr_pair(n_rows=23, n_cols=19, nnz=140, seed=0):
    """One unsorted CSR with duplicates, in both packages."""
    rows, cols, vals = _triplets(n_rows, n_cols, nnz, seed)
    order = np.argsort(rows, kind="stable")
    indptr = np.concatenate(([0], np.cumsum(np.bincount(
        rows, minlength=n_rows)))).astype(np.int64)
    args = (n_rows, n_cols, indptr, cols[order].astype(np.int64),
            vals[order])
    return (tm.CSRMatrix(*[np.copy(a) for a in args]),
            jm.CSRMatrix(*[np.copy(a) for a in args]))


@pytest.mark.parametrize("drop_tol", [None, 0.0, 0.5])
def test_csr_canonicalize_matches_jax(drop_tol):
    """The canonical arrays are JAX's; the port's input keeps its arrays
    (JAX's sums into its input's arrays in place)."""
    t, j = _csr_pair()
    before = t.copy()
    _same(t.canonicalize(drop_tol=drop_tol),
          j.canonicalize(drop_tol=drop_tol), CSR)
    _same(t, before, CSR)
    _same(t.canonicalize(drop_tol=drop_tol),
          t.canonicalize(drop_tol=drop_tol), CSR)


def test_csr_products_match_jax():
    """``mult``, ``mult_T`` and ``residual`` on the unsorted CSR."""
    t, j = _csr_pair()
    rng = np.random.default_rng(1)
    x, y, b = (rng.standard_normal(19), rng.standard_normal(23),
               rng.standard_normal(23))
    _bits(t.mult(x), j.mult(x))
    _bits(t.mult_T(y), j.mult_T(y))
    _bits(t.residual(x, b), j.residual(x, b))


@pytest.mark.parametrize("op", ["add", "subtract"])
def test_csr_add_subtract_match_jax(op):
    t, j = _csr_pair()
    t2, j2 = _csr_pair(seed=5)
    _same(getattr(t, op)(t2), getattr(j, op)(j2), CSR)


def test_coo_matches_jax():
    """COO -> CSR sums the duplicates as JAX's; CSR -> COO gives its
    arrays."""
    rows, cols, vals = _triplets(17, 21, 160, 2)
    t = tm.COOMatrix(17, 21, rows.copy(), cols.copy(), vals.copy())
    j = jm.COOMatrix(17, 21, rows.copy(), cols.copy(), vals.copy())
    assert t.nnz == j.nnz == 160
    _same(t.to_csr(), j.to_csr(), CSR)
    tc, jc = _csr_pair()
    _same(tm.COOMatrix.from_csr(tc), jm.COOMatrix.from_csr(jc),
          ("n_rows", "n_cols", "row", "col", "data"))


def test_csc_matches_jax():
    tc, jc = _csr_pair()
    t, j = tm.CSCMatrix.from_csr(tc), jm.CSCMatrix.from_csr(jc)
    _same(t, j, CSR)
    assert t.nnz == j.nnz
    _same(t.to_csr(), j.to_csr(), CSR)
    _same(t.transpose(), j.transpose(), CSR)
    x = np.random.default_rng(3).standard_normal(19)
    _bits(t.mult(x), j.mult(x))


def _bcoo_input(nbr, nbc, b_rows, b_cols, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, nbr, n)
    cols = rng.integers(0, nbc, n)
    blocks = rng.standard_normal((n, b_rows, b_cols))
    return rows, cols, blocks


@pytest.mark.parametrize("b_rows,b_cols", [(2, 2), (2, 3), (3, 3)])
def test_bcoo_to_bsr_sums_duplicates_as_jax(b_rows, b_cols):
    """BCOO -> BSR: duplicate blocks summed by ``np.unique`` +
    ``np.add.reduceat`` in JAX's order, bit for bit; and BSR -> BCOO."""
    nbr, nbc = 9, 7
    rows, cols, blocks = _bcoo_input(nbr, nbc, b_rows, b_cols, 90, b_cols)
    assert len(set(zip(rows, cols))) < len(rows)      # duplicates
    args = (nbr * b_rows, nbc * b_cols, b_rows, b_cols)
    t = tm.BCOOMatrix(*args, rows.copy(), cols.copy(), blocks.copy())
    j = jm.BCOOMatrix(*args, rows.copy(), cols.copy(), blocks.copy())
    tb, jb = t.to_bsr(), j.to_bsr()
    _same(tb, jb, BSR)
    _same(tm.BCOOMatrix.from_bsr(tb), jm.BCOOMatrix.from_bsr(jb),
          ("n_rows", "n_cols", "b_rows", "b_cols", "row", "col", "blocks"))


@pytest.mark.parametrize("b_rows,b_cols", [(2, 2), (2, 3)])
def test_bsc_round_trip_matches_jax(b_rows, b_cols):
    nbr, nbc = 8, 6
    rows, cols, blocks = _bcoo_input(nbr, nbc, b_rows, b_cols, 40, 7)
    args = (nbr * b_rows, nbc * b_cols, b_rows, b_cols)
    tb = tm.BCOOMatrix(*args, rows, cols, blocks).to_bsr()
    jb = jm.BCOOMatrix(*args, rows, cols, blocks).to_bsr()
    t, j = tm.BSCMatrix.from_bsr(tb), jm.BSCMatrix.from_bsr(jb)
    _same(t, j, BSR)
    _same(t.to_bsr(), j.to_bsr(), BSR)
    np.testing.assert_array_equal(t.to_bsr().to_scipy().toarray(),
                                  tb.to_scipy().toarray())


def _compare_cases():
    """(a, b, keyword arguments) in both packages: equal matrices, equal
    but for duplicates and explicit zeros, and each kind of mismatch."""
    t, j = _csr_pair()
    base = t.canonicalize(drop_tol=0.0)
    m = base.to_scipy()

    def both(s):
        s = sp.csr_matrix(s)
        args = (s.shape[0], s.shape[1], s.indptr.astype(np.int64),
                s.indices.astype(np.int64), s.data.astype(np.float64))
        return (tm.CSRMatrix(*[np.copy(a) for a in args]),
                jm.CSRMatrix(*[np.copy(a) for a in args]))

    moved = m.copy()
    moved.data = moved.data + 1e-3
    extra = m.tolil()
    extra[0, 18] = 3.0
    shifted = sp.vstack([m[1:], m[:1]]).tocsr()
    return {
        "equal": ((t, j), both(m), {}),
        "values": ((t, j), both(moved), {}),
        "values_within_atol": ((t, j), both(moved), {"atol": 1e-2}),
        "values_pattern_only": ((t, j), both(moved),
                                {"pattern_only": True}),
        "col_pattern": ((t, j), both(extra), {}),
        "row_pattern": ((t, j), both(shifted), {}),
        "shape": ((t, j), both(m[:, :18]), {}),
    }


@pytest.mark.parametrize("case", ["equal", "values", "values_within_atol",
                                  "values_pattern_only", "col_pattern",
                                  "row_pattern", "shape"])
def test_compare_raises_where_jax_raises(case):
    (ta, ja), (tb, jb), kw = _compare_cases()[case]
    try:
        jm.compare(ja, jb, **kw)
        jerr = None
    except AssertionError as e:
        jerr = str(e)
    if jerr is None:
        tm.compare(ta, tb, **kw)
    else:
        with pytest.raises(AssertionError) as e:
            tm.compare(ta, tb, **kw)
        assert str(e.value) == jerr
    assert (jerr is None) == (case in ("equal", "values_within_atol",
                                       "values_pattern_only"))


def _aniso(n, shards):
    return (tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                                 shards),
            jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (n, n),
                                 shards))


def _local_view(pkg, a):
    """A local view holding every shard of ``a`` (global columns)."""
    G = a.global_num_cols
    blocks = [blk.global_cols_csr(G) for blk in a.shards()]
    return pkg.ParCSRMatrix.from_local_rows(blocks, a.partition)


def _same_par(t, j):
    """Two ParCSRMatrix equal: partitions and, for an in-process one, the
    global CSR; for a local view every shard's blocks."""
    for f in ("row_bounds", "col_bounds"):
        _bits(getattr(t.partition, f), getattr(j.partition, f))
    assert t.is_local_view == j.is_local_view
    assert t.first_shard == j.first_shard
    if not j.is_local_view:
        _same(t.global_csr, j.global_csr, CSR)
    for ts, js in zip(t.shards(), j.shards(), strict=True):
        _same(ts.on_proc, js.on_proc, CSR)
        _same(ts.off_proc, js.off_proc, CSR)
        _bits(ts.off_proc_column_map, js.off_proc_column_map)


@pytest.mark.parametrize("shards", SHARDS)
def test_par_csr_methods_match_jax(shards):
    """ParCSR's ``mult_T``, ``residual``, ``add`` and ``subtract``
    (tests/test_par_containers.py:test_par_add_subtract's operators)."""
    ta, ja = (tst.par_stencil_grid(tst.diffusion_stencil_2d(1.0, 0.0),
                                   (20, 22), shards),
              jst.par_stencil_grid(jst.diffusion_stencil_2d(1.0, 0.0),
                                   (20, 22), shards))
    tb = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (20, 22),
                              shards)
    jb = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (20, 22),
                              shards)
    x = np.random.default_rng(1).standard_normal(ta.global_num_cols)
    b = np.random.default_rng(2).standard_normal(ta.global_num_rows)
    _bits(ta.mult_T(x), ja.mult_T(x))
    _bits(ta.residual(x, b), ja.residual(x, b))
    _same_par(ta.add(tb), ja.add(jb))
    _same_par(ta.subtract(tb), ja.subtract(jb))


@pytest.mark.parametrize("shards", SHARDS)
def test_par_csr_copy_of_a_local_view_matches_jax(shards):
    ta, ja = _aniso(12, shards)
    _same_par(_local_view(tpm, ta).copy(), _local_view(jpm, ja).copy())


@pytest.mark.parametrize("shards", SHARDS)
def test_par_coo_finalize_matches_jax(shards):
    """Triplets with duplicates, added one by one and in chunks, finalized
    bit-equal to JAX's (duplicates summed in the order added)."""
    n = 37
    rows, cols, vals = _triplets(n, n, 600, 4)
    t = tpm.ParCOOMatrix(Partition.create(n, n, shards))
    j = jpm.ParCOOMatrix(JPartition.create(n, n, shards))
    for k in range(20):
        t.add_global_value(int(rows[k]), int(cols[k]), float(vals[k]))
        j.add_global_value(int(rows[k]), int(cols[k]), float(vals[k]))
    for lo in range(20, 600, 145):
        sl = slice(lo, lo + 145)
        t.add_values(rows[sl], cols[sl], vals[sl])
        j.add_values(rows[sl], cols[sl], vals[sl])
    _same_par(t.finalize(), j.finalize())


def test_par_coo_halves_give_the_stencil_matrix():
    """Each entry of the stencil matrix split into two exact halves and
    scrambled: ``finalize`` gives the matrix back bit for bit (the
    assembly chip_smoke.py's phase 20a runs at full size)."""
    ta, ja = _aniso(16, 1)
    g = ta.global_csr
    rows, cols, vals = g.row_ids(), g.indices, g.data
    perm = np.random.default_rng(0).permutation(2 * g.nnz)
    t = tpm.ParCOOMatrix(ta.partition)
    t.add_values(np.tile(rows, 2)[perm], np.tile(cols, 2)[perm],
                 np.tile(vals / 2, 2)[perm])
    _same_par(t.finalize(), ja)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("local", [False, True])
def test_par_csc_matches_jax(shards, local):
    """ParCSC in both storage modes: its CSC arrays, every local CSC
    block, the round trip and the transpose (on a local view the
    distributed one over the in-process transport)."""
    ta, ja = _aniso(20, shards)
    if local:
        ta, ja = _local_view(tpm, ta), _local_view(jpm, ja)
    t, j = tpm.ParCSCMatrix(ta), jpm.ParCSCMatrix(ja)
    assert (t.csc is None) == (j.csc is None) == local
    if not local:
        _same(t.csc, j.csc, CSR)
    for i in range(shards):
        _same(t.local_csc(i), j.local_csc(i), CSR)
    _same_par(t.to_par_csr(), j.to_par_csr())
    tt, jt = t.transpose(), j.transpose()
    _same_par(tt, jt)
    ref = ja.assemble_global().to_scipy().T.tocsr()
    got = tt.assemble_global().to_scipy()
    assert abs(got - ref).max() == 0.0


def _elasticity(shards):
    return (tfem.par_fem("elasticity", 12, 6, shards)[0],
            jfem.par_fem("elasticity", 12, 6, shards)[0])


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("local", [False, True])
def test_par_bsr_matches_jax(shards, local):
    """ParBSR in both storage modes (a local view redistributed to block
    boundaries through the in-process transport's ``reduce_rows``): its
    partition, ParCSR and every shard's BSR block bit-equal to JAX's."""
    ta, ja = _elasticity(shards)
    if local:
        ta, ja = _local_view(tpm, ta), _local_view(jpm, ja)
    t, j = tpm.ParBSRMatrix(ta, 2), jpm.ParBSRMatrix(ja, 2)
    assert t.par_csr.is_local_view == local
    _same_par(t.par_csr, j.par_csr)
    assert t.global_num_rows == j.global_num_rows
    for s in range(shards):
        _same(t.local_bsr(s), j.local_bsr(s), BSR)
    x = np.random.default_rng(0).standard_normal(ta.global_num_cols)
    if not local:
        _bits(t.mult(x), j.mult(x))


@pytest.mark.parametrize("shards", SHARDS)
def test_par_bsr_to_device_spmv_matches_jax(shards):
    """``to_device("cpu")`` + ``bsr_spmv`` against JAX's ``to_device`` on
    its CPU mesh + ``bsr_spmv``, float64, to 1e-13 of max |y|, and
    against the host product."""
    ta, ja = _elasticity(shards)
    t, j = tpm.ParBSRMatrix(ta, 2), jpm.ParBSRMatrix(ja, 2)
    mesh = jpar.make_mesh(shards)
    dt, dj = t.to_device("cpu"), j.to_device(mesh)
    assert dt.on_blocks.dtype == torch.float64
    x = np.random.default_rng(3).standard_normal(ta.global_num_cols)
    cb = t.partition.col_bounds
    pad = dt.bcols_pad * 2
    yt = tbsr.bsr_spmv(dt, tpar.device_put_vector(x, cb, pad, device="cpu"))
    yj = np.asarray(jbsr.bsr_spmv(mesh, dj, jpar.device_put_vector(
        x, cb, pad, mesh)))
    scale = np.abs(yj).max()
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-13 * scale)
    np.testing.assert_allclose(tpar.host_vector(yt, t.partition.row_bounds),
                               t.mult(x), rtol=0, atol=1e-13 * scale)


def test_par_bsr_to_device_defaults_to_cuda(monkeypatch):
    """``to_device()`` asks for CUDA and raises where there is none."""
    ta, _ = _elasticity(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpm.ParBSRMatrix(ta, 2).to_device()


@pytest.mark.parametrize("shards", SHARDS)
def test_par_bcoo_finalize_matches_jax(shards):
    """The elasticity operator's 2 x 2 blocks, each split into two exact
    halves and added in a seeded scrambled order: ``finalize`` bit-equal
    to JAX's and equal to the operator."""
    ta, ja = _elasticity(shards)
    tb = tm.BSRMatrix.from_csr(ta.global_csr, 2, 2)
    rows = np.repeat(np.arange(tb.n_block_rows), np.diff(tb.indptr))
    perm = np.random.default_rng(shards).permutation(2 * len(rows))
    r2, c2 = np.tile(rows, 2)[perm], np.tile(tb.indices, 2)[perm]
    b2 = np.tile(tb.blocks / 2, (2, 1, 1))[perm]
    t = tpm.ParBCOOMatrix(ta.partition, 2)
    j = jpm.ParBCOOMatrix(ja.partition, 2)
    for r, c, blk in zip(r2, c2, b2):
        t.add_block(r, c, blk)
        j.add_block(r, c, blk)
    tf, jf = t.finalize(), j.finalize()
    assert (tf.b_rows, tf.b_cols) == (jf.b_rows, jf.b_cols) == (2, 2)
    _same_par(tf.par_csr, jf.par_csr)
    ref = ta.global_csr.to_scipy()
    assert abs(tf.par_csr.global_csr.to_scipy() - ref).max() == 0.0


@pytest.mark.parametrize("shards", SHARDS)
def test_par_bsc_matches_jax(shards):
    ta, ja = _elasticity(shards)
    t = tpm.ParBSCMatrix(tpm.ParBSRMatrix(ta, 2))
    j = jpm.ParBSCMatrix(jpm.ParBSRMatrix(ja, 2))
    for s in range(shards):
        _same(t.local_bsc(s), j.local_bsc(s), BSR)
        _same(t.local_bsc(s).to_bsr(), t.to_par_bsr().local_bsr(s), BSR)
    assert t.to_par_bsr() is t.par_bsr
