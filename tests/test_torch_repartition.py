"""The port's repartitioning and diagonal scaling (``linalg/repartition.py``,
``linalg/diag_scale.py``) against the JAX package's: k-way and RCM labels,
``make_contiguous`` / ``repartition_matrix`` matrices and permutations,
``comm_volume``, the label-propagation partitioner and the distributed row
migration over the in-process transport (the cases of
tests/test_linalg_util.py, on seeded matrices in place of the reference's
files), all equal; the scalings equal bit for bit; the scaled-AMG solve of
tests/test_linalg_util.py::test_scaled_amg_solves_original_system on the
port in JAX's V-cycles.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu.comm.transport import (  # noqa: E402
    InProcessTransport as JTransport)
from raptor_tpu.core.par_matrix import ParCSRMatrix as JPar  # noqa: E402
from raptor_tpu.core.par_matrix import (  # noqa: E402
    par_matrix_from_scipy as jfrom_scipy)
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.linalg import diag_scale as jds  # noqa: E402
from raptor_tpu.linalg import repartition as jrep  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu_torch import native  # noqa: E402
from raptor_tpu_torch.comm.transport import InProcessTransport  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.par_matrix import (  # noqa: E402
    par_matrix_from_scipy)
from raptor_tpu_torch.linalg import diag_scale as tds  # noqa: E402
from raptor_tpu_torch.linalg import repartition as trep  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import _one_intra_op_thread, aniso, to_port  # noqa: E402,F401,E501


def _unstructured(n=400, seed=7):
    """tests/test_multiproc.py's unstructured SPD-like operator."""
    m = sp.random(n, n, density=0.02, random_state=seed, format="csr")
    m = (m + m.T + sp.diags(np.ones(n) * 4)).tocsr()
    m.sort_indices()
    return m


def _problems():
    """(name, JAX matrix, port matrix): the 25^2 anisotropic operator on 4
    shards, a 12 x 10 DG operator on 8 and the unstructured one on 4."""
    a = aniso(25, 4)
    dg = jpar_fem("dg_diffusion", 12, 10, 8)
    un = jfrom_scipy(_unstructured(), 4)
    return [(name, j, to_port(j)) for name, j in
            (("aniso", a), ("dg", dg), ("unstructured", un))]


PROBLEMS = {name: (j, t) for name, j, t in _problems()}


def _same_par(t, j):
    """Port and JAX ParCSRMatrix equal bit for bit, partition included."""
    for f in ("row_bounds", "col_bounds"):
        np.testing.assert_array_equal(getattr(t.partition, f),
                                      getattr(j.partition, f))
    tg, jg = t.global_csr, j.global_csr
    assert tg.shape == jg.shape
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    assert tg.data.tobytes() == jg.data.tobytes()


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("method", ["kway", "rcm"])
def test_partition_and_repartition_match_jax(name, method):
    j, t = PROBLEMS[name]
    k = j.partition.n_shards
    jp = jrep.partition_graph(j, k, method=method)
    tp = trep.partition_graph(t, k, method=method)
    np.testing.assert_array_equal(tp, jp)
    assert set(np.unique(tp)) == set(range(k))
    assert trep.comm_volume(t, tp) == jrep.comm_volume(j, jp)
    tA, tperm = trep.repartition_matrix(t, tp)
    jA, jperm = jrep.repartition_matrix(j, jp)
    np.testing.assert_array_equal(tperm, jperm)
    _same_par(tA, jA)
    # the permuted operator acts like the original under the permutation
    x = np.random.default_rng(2).standard_normal(t.global_num_cols)
    np.testing.assert_allclose(tA.mult(x[tperm]), t.mult(x)[tperm],
                               atol=1e-12)


def test_kway_beats_the_block_partition():
    """On the DG operator the k-way cut and halo are below the block
    partition's and RCM's, within the refiner's balance."""
    _, t = PROBLEMS["dg"]
    n, k = t.global_num_rows, 8
    vk = trep.comm_volume(t, trep.partition_graph(t, k))
    vr = trep.comm_volume(t, trep.partition_graph(t, k, method="rcm"))
    vb = trep.comm_volume(t, np.repeat(np.arange(k),
                                       np.diff(t.partition.row_bounds)))
    assert vk["edge_cut"] < min(vr["edge_cut"], vb["edge_cut"])
    assert vk["halo_values"] < min(vr["halo_values"], vb["halo_values"])
    assert vk["max_part_rows"] <= int(np.ceil(1.06 * n / k))


def test_partition_graph_has_no_fallback(monkeypatch):
    """JAX's partition_graph turns to RCM when its native library is
    missing; the port's raises, and refuses methods it does not run."""
    _, t = PROBLEMS["aniso"]

    def broken():
        raise RuntimeError("building setup_kernels.cpp failed")
    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(RuntimeError, match="failed"):
        trep.partition_graph(t, 4)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="lp"):
        trep.partition_graph(t, 4, method="lp")
    with pytest.raises(ValueError):
        trep.partition_graph(t, 4, method="metis")


def test_make_contiguous_identity():
    _, t = PROBLEMS["aniso"]
    n = t.global_num_rows
    proc = np.repeat(np.arange(4), n // 4 + 1)[:n]
    An, perm = trep.make_contiguous(t, proc)
    jn, jperm = jrep.make_contiguous(PROBLEMS["aniso"][0], proc)
    np.testing.assert_array_equal(perm, np.arange(n))
    np.testing.assert_array_equal(jperm, perm)
    _same_par(An, jn)
    assert An.global_csr.data.tobytes() == t.global_csr.data.tobytes()


def _local_view(a, cls, first=0, count=None):
    """A local view of shards [first, first + count) of ``a`` (the port's
    or JAX's class), as a rank of the distributed setup holds it."""
    n = a.global_num_cols
    shards = a.shards()
    count = len(shards) - first if count is None else count
    blocks = [blk.global_cols_csr(n) for blk in shards[first:first + count]]
    return cls.from_local_rows(blocks, a.partition, first_shard=first)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_distributed_repartition_matches_jax(name):
    """tests/test_linalg_util.py::test_lp_partitioner_local_view_matches_
    global on the port: label propagation over the in-process transport
    equal to JAX's, on the global matrix and on a local view; the
    migration equal to make_contiguous on the same labels, bit for bit;
    the cut no worse than the block partition's, within the balance."""
    j, t = PROBLEMS[name]
    S, n = t.n_shards, t.global_num_rows
    tl = trep.dist_partition_graph(t, InProcessTransport(t))
    jl = jrep.dist_partition_graph(j, JTransport(j))
    assert len(tl) == S
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a, b)
    proc = np.concatenate(tl)
    block = np.repeat(np.arange(S), np.diff(t.partition.row_bounds))
    if name == "unstructured":
        assert (trep.comm_volume(t, proc)["edge_cut"]
                <= trep.comm_volume(t, block)["edge_cut"])
    assert np.bincount(proc, minlength=S).max() <= int(np.ceil(n / S * 1.05))

    ref, perm_ref = trep.make_contiguous(t, proc)
    tv = _local_view(t, ParCSRMatrix)
    tr = InProcessTransport(tv)
    labels = trep.partition_graph(tv, tr=tr)
    for a, b in zip(labels, tl):
        np.testing.assert_array_equal(a, b)
    new, perms = trep.repartition_matrix(tv, labels, tr=tr)
    assert new.is_local_view
    np.testing.assert_array_equal(np.concatenate(perms), perm_ref)
    np.testing.assert_array_equal(new.partition.row_bounds,
                                  ref.partition.row_bounds)
    got, want = new.assemble_global(), ref.global_csr
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.data.tobytes() == want.data.tobytes()
    # and JAX's distributed migration gives the same matrix
    jv = _local_view(j, JPar)
    jnew, jperms = jrep.repartition_matrix(jv, jl, tr=JTransport(jv))
    np.testing.assert_array_equal(np.concatenate(jperms), perm_ref)
    jg = jnew.assemble_global()
    np.testing.assert_array_equal(jg.indices, want.indices)
    assert jg.data.tobytes() == want.data.tobytes()


def test_distributed_repartition_raises_for_bad_input():
    _, t = PROBLEMS["unstructured"]
    tv = _local_view(t, ParCSRMatrix)
    tr = InProcessTransport(tv)
    with pytest.raises(ValueError, match="assignments"):
        trep.repartition_matrix(tv, [np.zeros(3, np.int64)], tr=tr)
    with pytest.raises(ValueError, match="n_parts"):
        trep.dist_partition_graph(t, InProcessTransport(t), n_parts=3)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_scalings_match_jax(name):
    j, t = PROBLEMS[name]
    b = np.random.default_rng(1).standard_normal(t.global_num_rows)
    (tA, tb), (jA, jb) = tds.row_scale(t, b), jds.row_scale(j, b)
    _same_par(tA, jA)
    assert tb.tobytes() == jb.tobytes()
    (tA, tb, ts), (jA, jb, js) = (tds.diagonally_scale(t, b),
                                  jds.diagonally_scale(j, b))
    _same_par(tA, jA)
    assert tb.tobytes() == jb.tobytes() and ts.tobytes() == js.tobytes()
    np.testing.assert_allclose(np.abs(tA.diagonal()), 1.0, rtol=1e-14)
    assert (tds.diagonally_unscale(tb, ts).tobytes()
            == jds.diagonally_unscale(jb, js).tobytes())


def test_zero_diagonal_rows_get_scale_zero():
    m = sp.csr_matrix(np.array([[4.0, 1.0, 0.0], [1.0, 0.0, 2.0],
                                [0.0, 2.0, 9.0]]))
    t, j = par_matrix_from_scipy(m, 2), jfrom_scipy(m, 2)
    b = np.ones(3)
    tA, tb, ts = tds.diagonally_scale(t, b)
    jA, jb, js = jds.diagonally_scale(j, b)
    np.testing.assert_array_equal(ts, [0.5, 0.0, 1.0 / 3.0])
    assert ts.tobytes() == js.tobytes()
    _same_par(tA, jA)
    tA, tb = tds.row_scale(t, b)
    np.testing.assert_array_equal(tb, [0.25, 0.0, 1.0 / 9.0])
    assert not tA.global_csr.to_dense()[1].any()


def test_scaled_amg_solves_original_system():
    """tests/test_linalg_util.py's scale -> setup -> solve -> unscale flow
    on the port: the unscaled x solves the original system to 1e-8, in
    the JAX package's V-cycles, its residual history within 1e-6."""
    j, t = PROBLEMS["aniso"]
    b = j.mult(np.random.default_rng(3).random(j.global_num_rows))
    out = []
    for pkg, ds, RS, A in (("port", tds, ParRugeStubenSolver, t),
                           ("jax", jds, JRS, j)):
        As, bs, scales = ds.diagonally_scale(A, b)
        ml = RS(0.25)
        ml.solve_tol = 1e-9
        ml.rap_mode = ml.interp_mode = "host"
        ml.setup(As)
        if pkg == "port":
            dh = DeviceHierarchy(ml, dtype=torch.float64, device="cpu")
        else:
            dh = JDH(ml, jpar.make_mesh(4))
        res = dh.solve(dh.vector(np.zeros_like(bs)), dh.vector(bs))
        x = ds.diagonally_unscale(dh.host(res.x), scales)
        r = np.linalg.norm(b - A.mult(x)) / np.linalg.norm(b)
        assert r < 1e-8, (pkg, r)
        out.append((int(res.n_iters), np.asarray(res.res), x))
    (tk, th, tx), (jk, jh, jx) = out
    assert tk == jk
    # SOR's level-scheduled sweeps sum in another order than JAX's
    np.testing.assert_allclose(th[:tk + 1], jh[:jk + 1], rtol=1e-6)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10 * np.abs(jx).max())
