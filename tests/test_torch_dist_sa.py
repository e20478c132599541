"""The port's distributed smoothed-aggregation and blocked setups against
the JAX package's, on the same inputs: each SA stage of
``ruge_stuben.par_setup`` (symmetric strength, MIS(2), aggregation,
tentative candidates, Jacobi prolongation) at 1, 4 and 8 shards, the
``setup_mode = "distributed"`` SA and blocked hierarchies level by level,
the blocked solve on the distributed hierarchy, and the in-place checks
of the five native bindings the stages call.

The problems are the JAX package's own tests' (tests/test_dist_setup.py,
tests/test_bsr_amg.py): the rotated anisotropic diffusion on 30^2, the
isotropic one on 36^2, 24 x 12 Q1 plane-stress elasticity.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.aggregation.solver import (  # noqa: E402
    ParSmoothedAggregationSolver as JSA)
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.multilevel import bsr_hierarchy as jbh  # noqa: E402
from raptor_tpu.ruge_stuben import par_setup as jps  # noqa: E402
from raptor_tpu_torch import native  # noqa: E402
from raptor_tpu_torch.aggregation.aggregate import aggregate  # noqa: E402
from raptor_tpu_torch.aggregation.mis import mis2  # noqa: E402
from raptor_tpu_torch.aggregation.solver import (  # noqa: E402
    ParSmoothedAggregationSolver as TSA)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.multilevel import bsr_hierarchy as tbh  # noqa: E402
from raptor_tpu_torch.ruge_stuben import par_setup as ps  # noqa: E402
from raptor_tpu_torch.ruge_stuben.strength import (  # noqa: E402
    symmetric_strength)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

SHARDS = [1, 4, 8]
SA_PHASES = {"strength", "aggregation", "candidates", "prolongation", "RAP"}
BSR_PHASES = {"strength", "cf_splitting", "interpolation", "RAP"}


def _aniso(n, n_shards, coeffs=ANISO):
    """(port, JAX) matrices of the n x n diffusion problem."""
    return (tst.par_stencil_grid(tst.diffusion_stencil_2d(*coeffs), (n, n),
                                 n_shards),
            jst.par_stencil_grid(jst.diffusion_stencil_2d(*coeffs), (n, n),
                                 n_shards))


def _bytes_equal(t, j):
    """Two CSRs (either package) with the same shape and arrays."""
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices", "data"):
        assert getattr(t, f).tobytes() == getattr(j, f).tobytes(), f


def _close(t, j, atol):
    """Equal patterns, values within ``atol``."""
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_allclose(t.data, j.data, rtol=0, atol=atol)


@functools.lru_cache(maxsize=None)
def _sa_inputs(n_shards):
    """Both packages' 30^2 matrices, their distributed symmetric strength
    (theta 0.25) and the glibc weights."""
    tA, jA = _aniso(30, n_shards)
    tm = ps.dist_symmetric_strength(tA, theta=0.25)
    jm = jps.dist_symmetric_strength(jA, theta=0.25)
    return (tA, jA, tm, jm, ps.strength_masks_to_par(tA, tm),
            jps.strength_masks_to_par(jA, jm),
            form_rand_weights(tA.global_num_rows, 0))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_symmetric_strength(n_shards):
    """Keep-masks equal to JAX's; S equal to the port's global symmetric
    strength."""
    tA, jA, tm, jm, tS, jS, _ = _sa_inputs(n_shards)
    for (ton, toff), (jon, joff) in zip(tm, jm):
        np.testing.assert_array_equal(ton, jon)
        np.testing.assert_array_equal(toff, joff)
    _bytes_equal(tS.global_csr, jS.global_csr)
    _close(tS.global_csr, symmetric_strength(tA.global_csr, theta=0.25),
           1e-14)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_mis2(n_shards):
    """States equal to JAX's distributed MIS(2) and to the global one."""
    _, _, _, _, tS, jS, w = _sa_inputs(n_shards)
    st = ps.dist_mis2(tS, w)
    np.testing.assert_array_equal(st, jps.dist_mis2(jS, w))
    np.testing.assert_array_equal(st, mis2(tS.global_csr, w))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("rand", [False, True])
def test_dist_aggregate(n_shards, rand):
    """Aggregate ids and counts equal to JAX's, with and without
    tie-break weights; with them, equal to the global aggregation too
    (without them pass 2 meets equal strengths, and the shard's own
    neighbours come before its halo's where the global pass goes by
    column: at 4 shards 4 of 900 rows differ, in the JAX package's as
    well)."""
    tA, jA, _, _, tS, jS, w = _sa_inputs(n_shards)
    st = np.asarray(ps.dist_mis2(tS, w))
    r = w if rand else None
    n, aggs = ps.dist_aggregate(tA, tS, st, r)
    jn, jaggs = jps.dist_aggregate(jA, jS, st, r)
    assert n == jn
    np.testing.assert_array_equal(aggs, jaggs)
    gn, gaggs = aggregate(tA.global_csr, tS.global_csr, st, r)
    assert n == gn
    if rand or n_shards == 1:
        np.testing.assert_array_equal(aggs, gaggs)


def _aggregates(n_shards):
    tA, jA, _, _, tS, _, w = _sa_inputs(n_shards)
    st = np.asarray(ps.dist_mis2(tS, w))
    n, aggs = ps.dist_aggregate(tA, tS, st)
    return tA, jA, n, aggs


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_fit_candidates(n_shards):
    """T and the coarse candidate norms R within 1e-13 of JAX's, for a
    non-constant candidate; the per-shard blocks stack to T."""
    tA, jA, n, aggs = _aggregates(n_shards)
    B = np.random.default_rng(0).random(tA.global_num_rows) + 0.5
    T, R = ps.dist_fit_candidates(tA, n, aggs, B)
    jT, jR = jps.dist_fit_candidates(jA, n, aggs, B)
    _close(T, jT, 1e-13)
    np.testing.assert_allclose(R, jR, rtol=0, atol=1e-13)
    blocks, R2 = ps.dist_fit_candidates(tA, n, aggs, B, assemble=False)
    assert len(blocks) == n_shards
    np.testing.assert_array_equal(R2, R)
    rb = tA.partition.row_bounds
    for s, blk in enumerate(blocks):
        _bytes_equal(blk, T.row_slice(int(rb[s]), int(rb[s + 1])))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("steps", [1, 2])
def test_dist_jacobi_prolongation(n_shards, steps):
    """P = (I - w D~^-1 A)^k T equal in pattern to JAX's, values within
    1e-13, from the global T and from per-shard T blocks."""
    tA, jA, n, aggs = _aggregates(n_shards)
    B = np.ones(tA.global_num_rows)
    T, _ = ps.dist_fit_candidates(tA, n, aggs, B)
    jT, _ = jps.dist_fit_candidates(jA, n, aggs, B)
    P = ps.dist_jacobi_prolongation(tA, T, num_smooth_steps=steps)
    _close(P, jps.dist_jacobi_prolongation(jA, jT, num_smooth_steps=steps),
           1e-13)
    blocks, _ = ps.dist_fit_candidates(tA, n, aggs, B, assemble=False)
    _bytes_equal(ps.dist_jacobi_prolongation(tA, blocks,
                                             num_smooth_steps=steps), P)


# --- smoothed aggregation: setup_mode = "distributed" ------------------------

def _sa(package, A, mode):
    ml = (TSA if package == "port" else JSA)(0.0)
    ml.setup_mode = mode
    ml.setup(A)
    return ml


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sa_distributed_hierarchy_matches_jax(n_shards):
    """36^2 isotropic diffusion, theta 0: every level's A and P with their
    partitions, the coarse LU and the last candidate bit-equal to JAX's;
    the global branch's setup phases, the host engine recorded."""
    tA, jA = _aniso(36, n_shards, (1.0, 0.0))
    tml, jml = _sa("port", tA, "distributed"), _sa("jax", jA, "distributed")
    assert tml.num_levels == jml.num_levels >= 3
    for tl, jl in zip(tml.levels, jml.levels):
        for f in ("row_bounds", "col_bounds"):
            np.testing.assert_array_equal(getattr(tl.A.partition, f),
                                          getattr(jl.A.partition, f))
        _bytes_equal(tl.A.global_csr, jl.A.global_csr)
        assert (tl.P is None) == (jl.P is None)
        if tl.P is not None:
            _bytes_equal(tl.P.global_csr, jl.P.global_csr)
            np.testing.assert_array_equal(tl.P.partition.col_bounds,
                                          jl.P.partition.col_bounds)
    for t, j in zip(tml.coarse_lu, jml.coarse_lu):
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()
    assert tml.B.tobytes() == np.asarray(jml.B).tobytes()
    assert [set(d) for d in tml.setup_level_times] == \
        [SA_PHASES] * (tml.num_levels - 1)
    assert all(e == {"rap": "host", "rap_reason": "setup_mode=distributed"}
               for e in tml.level_engines)


def test_sa_distributed_one_shard_equals_global():
    """At one shard the distributed SA hierarchy is the global one."""
    tA, _ = _aniso(30, 1, (1.0, 0.0))
    d, g = _sa("port", tA, "distributed"), _sa("port", tA, "global")
    assert d.num_levels == g.num_levels >= 3
    for ld, lg in zip(d.levels, g.levels):
        _close(ld.A.global_csr, lg.A.global_csr, 1e-12)
        if lg.P is not None:
            _close(ld.P.global_csr, lg.P.global_csr, 1e-13)
    np.testing.assert_allclose(d.B, g.B, rtol=1e-13)


# --- blocked AMG: setup_mode = "distributed" ---------------------------------

@functools.lru_cache(maxsize=None)
def _bsr(package, n_shards, strength="Classical", mode="distributed"):
    """24 x 12 elasticity, CLJP + modified classical, theta 0.25 (the JAX
    package's distributed BSR tests)."""
    types, fem, solver = ((tt, par_fem, tbh.ParBSRRugeStubenSolver)
                          if package == "port" else
                          (jt, jpar_fem, jbh.ParBSRRugeStubenSolver))
    A, _ = fem("elasticity", 24, 12, n_shards)
    ml = solver(2, strong_threshold=0.25,
                coarsen_type=types.CoarsenType.CLJP,
                strength_type=getattr(types.StrengthType, strength))
    ml.setup_mode = mode
    ml.setup(A)
    return ml


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("strength", ["Classical", "Symmetric"])
def test_bsr_distributed_matches_jax(n_shards, strength):
    """Every level's A and P with their partitions, the nodal component
    prolongators and the coarse LU bit-equal to JAX's; the global
    branch's setup phases."""
    tml, jml = _bsr("port", n_shards, strength), _bsr("jax", n_shards,
                                                      strength)
    assert tml.num_levels == jml.num_levels >= 3
    for tl, jl in zip(tml.levels, jml.levels):
        for f in ("row_bounds", "col_bounds"):
            np.testing.assert_array_equal(getattr(tl.A.partition, f),
                                          getattr(jl.A.partition, f))
        _bytes_equal(tl.A.global_csr, jl.A.global_csr)
        if tl.P is not None:
            _bytes_equal(tl.P.global_csr, jl.P.global_csr)
    for tp, jp in zip(tml.p_nodals, jml.p_nodals):
        for t, j in zip(tp, jp):
            _bytes_equal(t, j)
    for t, j in zip(tml.coarse_lu, jml.coarse_lu):
        assert np.asarray(t).tobytes() == np.asarray(j).tobytes()
    assert [set(d) for d in tml.setup_level_times] == \
        [BSR_PHASES] * (tml.num_levels - 1)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_bsr_distributed_matches_global(n_shards):
    """The distributed blocked hierarchy against the port's global one,
    as tests/test_bsr_amg.py holds JAX's: equal patterns after a common
    1e-14 drop (summation order moves ulps across the 1e-16 one), values
    within 1e-12."""
    d, g = _bsr("port", n_shards), _bsr("port", n_shards, mode="global")
    assert d.num_levels == g.num_levels
    for ld, lg in zip(d.levels, g.levels):
        ad, ag = ld.A.global_csr.drop(1e-14), lg.A.global_csr.drop(1e-14)
        np.testing.assert_array_equal(ad.indptr, ag.indptr)
        np.testing.assert_array_equal(ad.indices, ag.indices)
        np.testing.assert_allclose(ad.data, ag.data, rtol=1e-12, atol=1e-14)
        if lg.P is not None:
            np.testing.assert_array_equal(ld.P.global_csr.indices,
                                          lg.P.global_csr.indices)
            np.testing.assert_allclose(ld.P.global_csr.data,
                                       lg.P.global_csr.data, rtol=1e-12)


def test_bsr_distributed_solve_matches_jax():
    """Block Chebyshev(3) V-cycles to 1e-6 on the 4-shard distributed
    hierarchy, b = A 1, float64: JAX's cycle count and history to 1e-9."""
    tml, jml = _bsr("port", 4), _bsr("jax", 4)
    b = tml.levels[0].A.mult(np.ones(tml.levels[0].A.global_num_rows))
    tdh = tbh.BSRDeviceHierarchy(tml, sweeps=3, lane_pad=1, device="cpu")
    x, hist, k = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b),
                           tol=1e-6, max_iter=100)
    jdh = jbh.BSRDeviceHierarchy(jml, jpar.make_mesh(4), sweeps=3)
    jx, jhist, jk = jdh.solve(jdh.vector(np.zeros_like(b)),
                              jdh.vector(b), tol=1e-6, max_iter=100)
    assert k == int(jk) > 3 and hist[k] < 1e-6
    np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-9,
                               atol=1e-16)
    jx = jdh.host(np.asarray(jx))
    np.testing.assert_allclose(tdh.host(x), jx, rtol=0,
                               atol=1e-9 * np.abs(jx).max())


def test_component_block_matches_jax():
    tml = _bsr("port", 4)
    A = tml.levels[0].A
    G = A.global_num_cols
    for blk in A.shards():
        g = blk.global_cols_csr(G)
        for c in range(2):
            _bytes_equal(tbh.component_block(g, 2, c),
                         jbh.component_block(g, blk.first_local_row, 2, c))


def test_bsr_distributed_needs_mod_classical():
    ml = tbh.ParBSRRugeStubenSolver(
        2, 0.25, interp_type=tt.InterpType.Direct)
    ml.setup_mode = "distributed"
    with pytest.raises(NotImplementedError, match="modified classical"):
        ml.setup(par_fem("elasticity", 16, 8, 2)[0])


# --- the native steps write in place -----------------------------------------

def _step_args():
    """One shard of two rows with one halo column: row 0 <-> row 1 on the
    shard, row 1 -> halo column 0 (global id 5), whose own row points at
    global 9."""
    one = np.array([0, 1, 2])
    return dict(on_indptr=one, on_indices=np.array([1, 0]),
                off_indptr=np.array([0, 0, 1]), off_indices=np.array([0]),
                hp_indptr=np.array([0, 1]), hp_cols=np.array([9]),
                fr=np.array([9]), fst=np.array([-1]))


def test_dist_mis2_steps_check_in_place_states():
    """Each step writes the states in place, so a copy made to fix a
    dtype or layout would lose its result: the bindings refuse them."""
    a = _step_args()
    rr, halo_r = np.array([0.1, 0.9]), np.array([0.5])
    st = np.array([-1, -1])
    native.dist_mis2_step1(a["on_indptr"], a["on_indices"], a["off_indptr"],
                           a["off_indices"], rr, halo_r, np.array([-1]), st)
    # row 0 becomes TmpSelection, which then blocks row 1
    assert st.tolist() == [int(tt.CFState.TmpSelection), -1]
    native.dist_mis2_step2(1, a["on_indptr"], a["on_indices"],
                           a["off_indptr"], a["off_indices"], a["hp_indptr"],
                           a["hp_cols"], rr, halo_r, np.array([-1]), a["fr"],
                           a["fst"], np.array([0.2]), st)
    assert st.tolist() == [int(tt.CFState.NewSelection), -1]
    native.dist_mis2_steps34(1, a["on_indptr"], a["on_indices"],
                             a["off_indptr"], a["off_indices"],
                             a["hp_indptr"], a["hp_cols"], np.array([-1]),
                             a["fr"], a["fst"], st)
    assert st.tolist() == [int(tt.CFState.NewSelection),
                           int(tt.CFState.NewUnselection)]
    for bad in (np.array([-1, -1], dtype=np.int32), np.array([-1] * 4)[::2]):
        with pytest.raises(ValueError, match="st"):
            native.dist_mis2_step1(a["on_indptr"], a["on_indices"],
                                   a["off_indptr"], a["off_indices"], rr,
                                   halo_r, np.array([-1]), bad)
    with pytest.raises(ValueError, match="halo"):
        native.dist_mis2_step2(2, a["on_indptr"], a["on_indices"],
                               a["off_indptr"], a["off_indices"],
                               a["hp_indptr"], a["hp_cols"], rr, halo_r,
                               np.array([-1]), a["fr"], a["fst"],
                               np.array([0.2]), np.array([-1, -1]))


def test_dist_aggregate_passes_check_in_place_ids():
    """Row 0 is a root (aggregate 3); pass 1 puts row 1 in it, and pass 2
    gives the unassigned row 1 of a second call the halo's aggregate 7,
    encoded as -(7 + 1)."""
    a = _step_args()
    s_args = (a["on_indptr"], a["on_indices"], a["off_indptr"],
              a["off_indices"])
    agg = np.array([3, -1])
    native.dist_aggregate_pass1(0, *s_args, np.array([5]), np.array([1, 0]),
                                np.array([0]), np.array([-1]), agg)
    assert agg.tolist() == [3, 3]
    agg = np.array([-1, -1])
    native.dist_aggregate_pass2(
        *s_args, a["on_indptr"], a["on_indices"], np.array([-1.0, -1.0]),
        a["off_indptr"], a["off_indices"], np.array([-2.0]), np.array([5]),
        np.array([5]), np.zeros(2), np.zeros(1), np.array([7]), agg)
    assert agg.tolist() == [0, -8]
    with pytest.raises(ValueError, match="agg"):
        native.dist_aggregate_pass1(0, *s_args, np.array([5]),
                                    np.array([1, 0]), np.array([0]),
                                    np.array([-1]), np.array([3.0, -1.0]))
