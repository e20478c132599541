"""The port's setup over real OS processes (``comm.multiproc``) against the
JAX package's in-process setups: the cases of tests/test_multiproc.py.

Each rank of ``run_spmd`` holds only its row block (a local-view matrix)
and runs the port's distributed stages or its whole-hierarchy setup
(``comm.spmd``) over ``MultiProcessTransport``. The stacked stages equal
the JAX package's in-process stages bit for bit (0.0 apart). The whole
hierarchies equal the JAX package's own setups over processes bit for
bit (the transport keeps JAX's arithmetic: ``ufunc.at`` in ``reduce``,
the reduce-scatter and allgather of ``allreduce_vec``), and its
in-process ``setup_mode="distributed"`` hierarchies in pattern, with the
values to JAX's tests/test_multiproc.py tolerance (rtol 1e-12, atol
1e-14): at 4 ranks the SA and blocked coarse levels over processes part
from the in-process ones by up to 9e-16, in the JAX package as in the
port. JAX's ``test_multiproc_repartition_kway`` is in
tests/test_torch_mp_repartition.py.

The problems are JAX's: 20^2 rotated anisotropic diffusion at 2 and 4
ranks, 64^2 at 8, and 24 x 12 Q1 plane-stress elasticity.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.aggregation.solver import (  # noqa: E402
    ParSmoothedAggregationSolver as JSA)
from raptor_tpu.comm import multiproc as jmp  # noqa: E402
from raptor_tpu.comm import spmd as jspmd  # noqa: E402
from raptor_tpu.core.par_matrix import ParCSRMatrix as JPar  # noqa: E402
from raptor_tpu.core.types import CFState  # noqa: E402
from raptor_tpu.core.types import CoarsenType as JC  # noqa: E402
from raptor_tpu.core.types import InterpType as JI  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.multilevel import bsr_hierarchy as jbh  # noqa: E402
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu.ruge_stuben import par_setup as jps  # noqa: E402
from raptor_tpu_torch.comm import spmd as tspmd  # noqa: E402
from raptor_tpu_torch.comm.multiproc import (  # noqa: E402
    MultiProcessTransport, run_spmd)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.multilevel import bsr_hierarchy as tbh  # noqa: E402
from raptor_tpu_torch.ruge_stuben import par_setup as ps  # noqa: E402
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

RS_CASES = [("pmis", "direct"), ("cljp", "mod_classical"),
            ("hmis", "direct"), ("falgout", "mod_classical"),
            ("hmis", "extended"), ("cljp", "extended")]


@functools.lru_cache(maxsize=None)
def _problem(n, world):
    """(port row blocks with global columns, port partition, JAX matrix,
    glibc weights) of the n x n anisotropic problem on ``world`` shards."""
    tA = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                              world)
    jA = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (n, n),
                              world)
    ncols = tA.partition.global_num_cols
    blocks = [blk.global_cols_csr(ncols) for blk in tA.shards()]
    return blocks, tA.partition, jA, form_rand_weights(n * n, 0)


def _jax_blocks(jA):
    """The JAX matrix's row blocks with global columns."""
    return [blk.global_cols_csr(jA.partition.global_num_cols)
            for blk in jA.shards()]


def _view(blocks, part, rank):
    """A rank's local view: its own row block only."""
    return ParCSRMatrix.from_local_rows([blocks[rank]], part,
                                        first_shard=rank)


def _stack(blocks):
    import scipy.sparse as sp
    g = sp.vstack([b.to_scipy() for b in blocks]).tocsr()
    g.sort_indices()
    return g


def _equal(got, want, what="", rtol=0.0, atol=0.0):
    """A stacked scipy CSR against a JAX CSRMatrix (or a stacked one): same
    shape and pattern, values bit for bit unless a tolerance is given."""
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.indptr, want.indptr, err_msg=what)
    np.testing.assert_array_equal(got.indices, want.indices, err_msg=what)
    if rtol or atol:
        np.testing.assert_allclose(got.data, want.data, rtol=rtol,
                                   atol=atol, err_msg=what)
    else:
        np.testing.assert_array_equal(got.data, want.data, err_msg=what)


def _coarse_bounds(states, row_bounds):
    sel = np.asarray(states) == CFState.Selected
    csum = np.concatenate([[0], np.cumsum(sel)])
    return csum[np.asarray(row_bounds)].astype(np.int64)


# --- one rank's work (forked; host NumPy and native code only) -------------

def _rs_worker(rank, group, blocks, part, w, coarsen, interp):
    a = _view(blocks, part, rank)
    tr = MultiProcessTransport(group, a)
    masks = ps.dist_classical_strength(a, 0.25, tr=tr)
    s_par = ps.strength_masks_to_par(a, masks)
    assert s_par.is_local_view
    tr_s = MultiProcessTransport(group, s_par)
    split = {"pmis": ps.dist_split_pmis, "cljp": ps.dist_split_cljp,
             "falgout": ps.dist_split_falgout,
             "hmis": ps.dist_split_hmis}[coarsen]
    states = split(s_par, w, tr=tr_s)
    if interp == "direct":
        p_blocks, _ = ps.dist_direct_interpolation(a, masks, states, tr=tr,
                                                   assemble=False)
    elif interp == "extended":
        p_blocks, _ = ps.dist_extended_interpolation(a, s_par, states,
                                                     tr=tr, assemble=False)
    else:
        p_blocks, _ = ps.dist_mod_classical_interpolation(
            a, s_par, states, tr=tr, assemble=False)
    cb = _coarse_bounds(states, part.row_bounds)
    c_blocks = ps.dist_rap(a, p_blocks, tr=tr, coarse_bounds=cb,
                           assemble=False)
    return np.asarray(states), p_blocks[0], c_blocks[0], cb


def _sa_worker(rank, group, blocks, part, w, b_cand):
    a = _view(blocks, part, rank)
    tr = MultiProcessTransport(group, a)
    masks = ps.dist_symmetric_strength(a, 0.25, tr=tr)
    s_par = ps.strength_masks_to_par(a, masks)
    tr_s = MultiProcessTransport(group, s_par)
    states = ps.dist_mis2(s_par, w, tr=tr_s)
    n_aggs, aggs = ps.dist_aggregate(a, s_par, states, w, tr=tr_s)
    t_blocks, R = ps.dist_fit_candidates(a, n_aggs, aggs, b_cand, tr=tr,
                                         assemble=False)
    p_blocks = ps.dist_jacobi_prolongation(a, t_blocks, tr=tr,
                                           assemble=False)
    return np.asarray(states), np.asarray(aggs), p_blocks[0], R


def _levels(h):
    """A rank's slice of an SPMD hierarchy: each level's row block with
    global columns, and the coarse LU."""
    return ([lvl.a_local.shards()[0].global_cols_csr(
        lvl.a_local.partition.global_num_cols) for lvl in h.levels],
        h.coarse_lu[0])


def _rs_setup_worker(rank, group, blocks, part, w, coarsen, interp):
    h = tspmd.spmd_rs_setup(
        _view(blocks, part, rank), w,
        lambda m: MultiProcessTransport(group, m),
        coarsen=tt.CoarsenType[coarsen], interp=tt.InterpType[interp])
    return _levels(h)


def _sa_setup_worker(rank, group, blocks, part, w):
    return _levels(tspmd.spmd_sa_setup(
        _view(blocks, part, rank), w,
        lambda m: MultiProcessTransport(group, m)))


def _bsr_setup_worker(rank, group, blocks, part, w, b):
    return _levels(tspmd.spmd_bsr_setup(
        _view(blocks, part, rank), b, w,
        lambda m: MultiProcessTransport(group, m)))


def _jax_levels(rank, group, blocks, part, w, kind, *args):
    """The JAX package's whole-hierarchy setup of one rank over its own
    process transport (forked from the JAX test process, as
    tests/test_multiproc.py forks)."""
    a = JPar.from_local_rows([blocks[rank]], part, first_shard=rank)

    def make_transport(m):
        return jmp.MultiProcessTransport(group, m)

    if kind == "bsr":
        h = jspmd.spmd_bsr_setup(a, args[0], w, make_transport)
    else:
        h = getattr(jspmd, f"spmd_{kind}_setup")(a, w, make_transport,
                                                 *args)
    return ([lvl.a_local.shards()[0].global_cols_csr(
        lvl.a_local.partition.global_num_cols) for lvl in h.levels],
        h.coarse_lu[0])


def _assert_levels(results, world, ml, jax_mp):
    """Every rank's levels, stacked: bit for bit the JAX package's setup
    over processes (``jax_mp``, its ranks' results), and ``ml``'s (the
    JAX in-process hierarchy) in pattern, values to rtol 1e-12; the
    replicated coarse LU the same on every rank and JAX's."""
    assert len(results[0][0]) == len(jax_mp[0][0]) == ml.num_levels
    for li, lvl in enumerate(ml.levels):
        got = _stack([results[r][0][li] for r in range(world)])
        _equal(got, _stack([jax_mp[r][0][li] for r in range(world)]),
               f"level {li} against JAX over processes")
        want = (lvl.A.assemble_global() if lvl.A.is_local_view
                else lvl.A.global_csr).to_scipy()
        _equal(got, want, f"level {li} against JAX in-process",
               rtol=1e-12, atol=1e-14)
    for r in range(world):
        np.testing.assert_array_equal(results[r][1], jax_mp[0][1])


# --- the cases ----------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("coarsen,interp", RS_CASES)
def test_multiproc_rs_pipeline_matches_jax(world, coarsen, interp):
    """Strength, CF splitting, interpolation and the Galerkin product of
    one level over ``world`` processes equal the JAX package's in-process
    stages bit for bit."""
    blocks, part, jA, w = _problem(20, world)
    results = run_spmd(world, _rs_worker, blocks, part, w, coarsen, interp)

    masks = jps.dist_classical_strength(jA, 0.25)
    s_par = jps.strength_masks_to_par(jA, masks)
    states = {"pmis": jps.dist_split_pmis, "cljp": jps.dist_split_cljp,
              "falgout": jps.dist_split_falgout,
              "hmis": jps.dist_split_hmis}[coarsen](s_par, w)
    if interp == "direct":
        P = jps.dist_direct_interpolation(jA, masks, states)
    elif interp == "extended":
        P = jps.dist_extended_interpolation(jA, s_par, states)
    else:
        P = jps.dist_mod_classical_interpolation(jA, s_par, states)
    cb = _coarse_bounds(states, part.row_bounds)
    C = jps.dist_rap(jA, P, coarse_bounds=cb)

    for rank in range(world):
        np.testing.assert_array_equal(results[rank][0], states)
        np.testing.assert_array_equal(results[rank][3], cb)
    _equal(_stack([r[1] for r in results]), P.to_scipy(), "P")
    _equal(_stack([r[2] for r in results]), C.to_scipy(), "RAP")


@pytest.mark.parametrize("world", [2, 4])
def test_multiproc_sa_pipeline_matches_jax(world):
    """Symmetric strength, MIS(2), aggregation, candidates and Jacobi
    prolongation over ``world`` processes equal JAX's in-process stages."""
    blocks, part, jA, w = _problem(20, world)
    b_cand = np.ones(400)
    results = run_spmd(world, _sa_worker, blocks, part, w, b_cand)

    masks = jps.dist_symmetric_strength(jA, 0.25)
    s_par = jps.strength_masks_to_par(jA, masks)
    states = jps.dist_mis2(s_par, w)
    n_aggs, aggs = jps.dist_aggregate(jA, s_par, states, w)
    T, R = jps.dist_fit_candidates(jA, n_aggs, aggs, b_cand)
    P = jps.dist_jacobi_prolongation(jA, T)

    for rank in range(world):
        states_r, aggs_r, _, R_r = results[rank]
        np.testing.assert_array_equal(states_r, states)
        np.testing.assert_array_equal(aggs_r, aggs)
        np.testing.assert_array_equal(R_r, R)
    _equal(_stack([r[2] for r in results]), P.to_scipy(), "P")


def test_local_view_never_holds_global():
    """A rank's local view refuses every global-matrix access, and a
    transport over processes refuses a view of more than one shard."""
    blocks, part, _, _ = _problem(20, 2)
    a = _view(blocks, part, 0)
    assert a.is_local_view
    with pytest.raises(RuntimeError, match="local-view"):
        a.nnz
    with pytest.raises(RuntimeError, match="local-view"):
        a.mult(np.ones(part.global_num_cols))
    both = ParCSRMatrix.from_local_rows(blocks, part, first_shard=0)

    class One:
        rank, world = 0, 2

    with pytest.raises(ValueError, match="one shard per rank"):
        MultiProcessTransport(One(), both)


def _jax_rs(jA, w, coarsen, interp):
    ml = JRS(0.25, JC[coarsen], JI[interp])
    ml.setup_mode = "distributed"
    ml.weights = w
    ml.setup(jA)
    return ml


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("coarsen,interp", [("HMIS", "Extended"),
                                            ("CLJP", "ModClassical")])
def test_spmd_rs_setup_over_processes_matches_jax(world, coarsen, interp):
    """``spmd_rs_setup`` builds the whole hierarchy rank by rank in real
    processes; every level equals the JAX package's in-process
    setup_mode="distributed" hierarchy bit for bit."""
    blocks, part, jA, w = _problem(20, world)
    results = run_spmd(world, _rs_setup_worker, blocks, part, w, coarsen,
                       interp)
    jax_mp = jmp.run_spmd(world, _jax_levels, _jax_blocks(jA), jA.partition,
                          w, "rs", JC[coarsen], JI[interp])
    _assert_levels(results, world, _jax_rs(jA, w, coarsen, interp), jax_mp)


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_sa_setup_over_processes_matches_jax(world):
    """``spmd_sa_setup`` in real processes equals the JAX package's
    in-process setup_mode="distributed" SA hierarchy bit for bit."""
    blocks, part, jA, w = _problem(20, world)
    results = run_spmd(world, _sa_setup_worker, blocks, part, w)
    jax_mp = jmp.run_spmd(world, _jax_levels, _jax_blocks(jA), jA.partition,
                          w, "sa")
    ml = JSA(strong_threshold=0.0)
    ml.setup_mode = "distributed"
    ml.weights = w
    ml.setup(jA)
    _assert_levels(results, world, ml, jax_mp)


def test_spmd_rs_setup_8_ranks_deep_matches_jax():
    """8 real processes on 64^2: a hierarchy at least five levels deep,
    equal to JAX's in-process distributed one bit for bit."""
    blocks, part, jA, w = _problem(64, 8)
    results = run_spmd(8, _rs_setup_worker, blocks, part, w, "HMIS",
                       "Extended")
    jax_mp = jmp.run_spmd(8, _jax_levels, _jax_blocks(jA), jA.partition,
                          w, "rs", JC.HMIS, JI.Extended)
    ml = _jax_rs(jA, w, "HMIS", "Extended")
    assert ml.num_levels >= 5
    _assert_levels(results, 8, ml, jax_mp)


@pytest.mark.parametrize("world", [2, 4])
def test_spmd_bsr_setup_over_processes_matches_jax(world):
    """The blocked (elasticity, 2 x 2 blocks) hierarchy built rank by rank
    in real processes equals the JAX package's in-process distributed
    blocked hierarchy, level by level, bit for bit."""
    b = 2
    tA, _ = par_fem("elasticity", 24, 12, world)
    part = tbh.block_partition(tA.global_num_rows, tA.global_num_cols, b,
                               world)
    tAp = ParCSRMatrix(tA.global_csr, part)
    blocks = [blk.global_cols_csr(part.global_num_cols)
              for blk in tAp.shards()]
    w = form_rand_weights(tA.global_num_rows // b, 0)
    results = run_spmd(world, _bsr_setup_worker, blocks, part, w, b)

    jA, _ = jpar_fem("elasticity", 24, 12, world)
    jpart = jbh.block_partition(jA.global_num_rows, jA.global_num_cols, b,
                                world)
    np.testing.assert_array_equal(jpart.row_bounds, part.row_bounds)
    jAp = JPar(jA._g(), jpart)
    jax_mp = jmp.run_spmd(world, _jax_levels, _jax_blocks(jAp), jpart, w,
                          "bsr", b)
    ml = jbh.ParBSRRugeStubenSolver(b, strong_threshold=0.25,
                                    coarsen_type=JC.CLJP)
    ml.setup_mode = "distributed"
    ml.weights = w
    ml.setup(jAp)
    # the processes keep the coarse partition of the C-nodes each rank
    # owns, the solver re-partitions evenly: compare assembled operators
    _assert_levels(results, world, ml, jax_mp)
