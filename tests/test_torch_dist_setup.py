"""The port's distributed Ruge-Stuben setup (``ruge_stuben.par_setup`` over
``comm.transport.InProcessTransport``) against the JAX package's same
stages on the same input, bit for bit, and against the port's own global
stages (the RS cases of tests/test_dist_setup.py); ``setup_mode =
"distributed"`` hierarchies against JAX's level by level; the systems and
sparsification knobs in global mode; and the knobs the port does not run,
which raise. The smoothed-aggregation and blocked
stages are in tests/test_torch_dist_sa.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.comm import transport as jtr  # noqa: E402
from raptor_tpu.core import par_matrix as jpm  # noqa: E402
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu.ruge_stuben import par_setup as jps  # noqa: E402
from raptor_tpu_torch import native  # noqa: E402
from raptor_tpu_torch.comm import transport as ttr  # noqa: E402
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as TRS)
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import interpolation as itp  # noqa: E402
from raptor_tpu_torch.ruge_stuben import par_setup as ps  # noqa: E402
from raptor_tpu_torch.ruge_stuben.strength import strength  # noqa: E402
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


SHARDS = [1, 4, 8]


def _aniso(n, n_shards, coeffs=ANISO):
    """(port, JAX) matrices of the n x n anisotropic problem."""
    return (tst.par_stencil_grid(tst.diffusion_stencil_2d(*coeffs), (n, n),
                                 n_shards),
            jst.par_stencil_grid(jst.diffusion_stencil_2d(*coeffs), (n, n),
                                 n_shards))


def _bytes_equal(t, j):
    """Two CSRs (either package) with the same shape and arrays."""
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    for f in ("indptr", "indices", "data"):
        assert getattr(t, f).tobytes() == getattr(j, f).tobytes(), f


def _close(t, ref, atol):
    np.testing.assert_array_equal(t.indptr, ref.indptr)
    np.testing.assert_array_equal(t.indices, ref.indices)
    np.testing.assert_allclose(t.data, ref.data, rtol=0, atol=atol)


def _strength_pair(n, n_shards):
    tA, jA = _aniso(n, n_shards)
    tm = ps.dist_classical_strength(tA, theta=0.25)
    jm = jps.dist_classical_strength(jA, theta=0.25)
    return tA, jA, tm, jm, ps.strength_masks_to_par(tA, tm), \
        jps.strength_masks_to_par(jA, jm)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_strength(n_shards):
    tA, _, tm, jm, tS, jS = _strength_pair(30, n_shards)
    for (ton, toff), (jon, joff) in zip(tm, jm):
        assert np.array_equal(ton, jon) and np.array_equal(toff, joff)
    _bytes_equal(tS.global_csr, jS.global_csr)
    for tb, jb in zip(tS.shards(), jS.shards()):
        _bytes_equal(tb.on_proc, jb.on_proc)
        _bytes_equal(tb.off_proc, jb.off_proc)
        assert np.array_equal(tb.off_proc_column_map,
                              jb.off_proc_column_map)
    _close(tS.global_csr, strength(tA, theta=0.25).global_csr, 1e-14)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("split", ["pmis", "cljp"])
def test_dist_pmis_cljp(n_shards, split):
    n = 30 if split == "pmis" else 20
    tA, jA = _aniso(n, n_shards)
    tS, jS = strength(tA, theta=0.25), _jax_strength(jA)
    w = form_rand_weights(tA.global_num_rows, 0)
    got = getattr(ps, f"dist_split_{split}")(tS, w)
    assert np.array_equal(got, getattr(jps, f"dist_split_{split}")(jS, w))
    assert np.array_equal(got, getattr(cf, f"split_{split}")(tS, w))


def _jax_strength(jA):
    """JAX's global classical strength of a JAX matrix."""
    from raptor_tpu.ruge_stuben.strength import strength as jstrength
    return jstrength(jA, theta=0.25)


def test_dist_pmis_larger_problem():
    tA, jA = _aniso(64, 8, (1.0, 0.0))
    tS = strength(tA, theta=0.25)
    w = form_rand_weights(tA.global_num_rows, 0)
    got = ps.dist_split_pmis(tS, w)
    assert np.array_equal(got, jps.dist_split_pmis(_jax_strength(jA), w))
    assert np.array_equal(got, cf.split_pmis(tS, w))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_direct_interpolation(n_shards):
    tA, jA, tm, jm, tS, jS = _strength_pair(30, n_shards)
    w = form_rand_weights(tA.global_num_rows, 0)
    states = np.asarray(cf.split_pmis(tS, w))
    P = ps.dist_direct_interpolation(tA, tm, states)
    _bytes_equal(P, jps.dist_direct_interpolation(jA, jm, states))
    _close(P, itp.direct_interpolation(tA.global_csr, tS.global_csr,
                                       states), 1e-13)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_rap_and_transpose(n_shards):
    tA, jA = _aniso(30, n_shards)
    tS = strength(tA, theta=0.25)
    w = form_rand_weights(tA.global_num_rows, 0)
    states = np.asarray(cf.split_pmis(tS, w))
    P = itp.direct_interpolation(tA.global_csr, tS.global_csr, states)
    C = ps.dist_rap(tA, P)
    _bytes_equal(C, jps.dist_rap(jA, to_jax_csr(P)))
    _close(C, P.T_multiply(tA.global_csr.multiply(P)), 1e-12)
    # the distributed transpose of P, and its local blocks
    part = Partition.create(P.n_rows, P.n_cols, n_shards)
    tP = ParCSRMatrix(P, part)
    jP = jpm.ParCSRMatrix(to_jax_csr(P), jpm.Partition(
        part.global_num_rows, part.global_num_cols, n_shards,
        part.row_bounds, part.col_bounds))
    Pt = ps.dist_transpose(tP)
    _bytes_equal(Pt, jps.dist_transpose(jP))
    _close(Pt, P.transpose(), 0.0)
    blocks = ps.dist_transpose(tP, assemble=False)
    for tb, jb in zip(blocks, jps.dist_transpose(jP, assemble=False)):
        _bytes_equal(tb, jb)


def to_jax_csr(m):
    """A port CSR as a JAX-package one."""
    from raptor_tpu.core.matrix import CSRMatrix as JCSR
    return JCSR(m.n_rows, m.n_cols, m.indptr.copy(), m.indices.copy(),
                m.data.copy())


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_mod_classical(n_shards):
    tA, jA = _aniso(24, n_shards)
    tS, jS = strength(tA, theta=0.25), _jax_strength(jA)
    w = form_rand_weights(tA.global_num_rows, 0)
    states = np.asarray(cf.split_cljp(tS, w))
    P = ps.dist_mod_classical_interpolation(tA, tS, states)
    _bytes_equal(P, jps.dist_mod_classical_interpolation(jA, jS, states))
    _close(P, itp.mod_classical_interpolation(tA.global_csr, tS.global_csr,
                                              states), 1e-13)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("split", ["pmis", "hmis", "cljp"])
def test_dist_extended(n_shards, split):
    tA, jA = _aniso(24, n_shards)
    tS, jS = strength(tA, theta=0.25), _jax_strength(jA)
    w = form_rand_weights(tA.global_num_rows, 0)
    states = np.asarray(getattr(cf, f"split_{split}")(tS, w))
    P = ps.dist_extended_interpolation(tA, tS, states)
    _bytes_equal(P, jps.dist_extended_interpolation(jA, jS, states))
    _close(P, itp.extended_interpolation(tA.global_csr, tS.global_csr,
                                         states), 1e-13)
    # the per-shard blocks (assemble=False)
    blocks, nc = ps.dist_extended_interpolation(tA, tS, states,
                                                assemble=False)
    jblocks, jnc = jps.dist_extended_interpolation(jA, jS, states,
                                                   assemble=False)
    assert nc == jnc
    for tb, jb in zip(blocks, jblocks):
        _bytes_equal(tb, jb)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_dist_falgout_hmis(n_shards):
    """Falgout and HMIS equal JAX's at every shard count, equal the global
    splittings at one shard, and keep a strong C neighbour for every F
    point at more (their interior passes depend on the partition, as the
    reference's hybrids depend on the rank count)."""
    n = 24 if n_shards == 1 else 30
    tA, jA = _aniso(n, n_shards)
    tS, jS = strength(tA, theta=0.25), _jax_strength(jA)
    w = form_rand_weights(tA.global_num_rows, 0)
    g = tS.global_csr.to_scipy()
    gT = g.T.tocsr()
    for name in ("falgout", "hmis"):
        st = getattr(ps, f"dist_split_{name}")(tS, w)
        assert np.array_equal(st, getattr(jps, f"dist_split_{name}")(jS, w))
        if n_shards == 1:
            assert np.array_equal(st, getattr(cf, f"split_{name}")(tS, w))
            continue
        sel = st == tt.CFState.Selected
        assert sel.any()
        for i in np.nonzero(st == tt.CFState.Unselected)[0]:
            nb = np.concatenate([g.indices[g.indptr[i]:g.indptr[i + 1]],
                                 gT.indices[gT.indptr[i]:gT.indptr[i + 1]]])
            assert sel[nb[nb != i]].any(), f"F point {i}: no C neighbour"


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("split,interp", [("pmis", "direct"),
                                          ("cljp", "mod_classical")])
def test_dist_pipeline(n_shards, split, interp):
    """Strength -> split -> P -> RAP chained over levels, each distributed
    stage equal to JAX's and to the port's global one; both chains go on
    from the distributed product."""
    n = 24 if split == "pmis" else 20
    tA, jA = _aniso(n, n_shards)
    w = form_rand_weights(tA.global_num_rows, 0)
    for _ in range(3):
        if tA.global_num_rows <= 40:
            break
        tm = ps.dist_classical_strength(tA, theta=0.25)
        tS = ps.strength_masks_to_par(tA, tm)
        jm = jps.dist_classical_strength(jA, theta=0.25)
        jS = jps.strength_masks_to_par(jA, jm)
        st = getattr(ps, f"dist_split_{split}")(tS, w)
        assert np.array_equal(st, getattr(jps, f"dist_split_{split}")(jS, w))
        gS = strength(ParCSRMatrix(tA.global_csr, tA.partition), theta=0.25)
        assert np.array_equal(st, getattr(cf, f"split_{split}")(gS, w))
        if interp == "direct":
            P = ps.dist_direct_interpolation(tA, tm, st)
            jP = jps.dist_direct_interpolation(jA, jm, st)
        else:
            P = ps.dist_mod_classical_interpolation(tA, tS, st)
            jP = jps.dist_mod_classical_interpolation(jA, jS, st)
        _bytes_equal(P, jP)
        C = ps.dist_rap(tA, P)
        _bytes_equal(C, jps.dist_rap(jA, jP))
        ref_p = getattr(itp, f"{interp}_interpolation")(
            tA.global_csr, gS.global_csr, st)
        _close(C, ref_p.T_multiply(tA.global_csr.multiply(ref_p)), 1e-12)
        part = Partition.create(C.n_rows, C.n_cols, n_shards)
        tA = ParCSRMatrix(C, part)
        jA = jpm.ParCSRMatrix(to_jax_csr(C), jpm.Partition(
            part.global_num_rows, part.global_num_cols, n_shards,
            part.row_bounds, part.col_bounds))


DIST_CONFIGS = [("HMIS", "Extended"), ("CLJP", "ModClassical"),
                ("RS", "Direct"), ("PMIS", "Extended"),
                ("Falgout", "ModClassical")]


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("coarsen,interp", DIST_CONFIGS)
def test_distributed_setup_mode_matches_jax(n_shards, coarsen, interp):
    """setup_mode="distributed" hierarchies: every A and P bytes-equal to
    JAX's, with equal partitions; every level on the host engines with
    the reason recorded."""
    tA, jA = _aniso(32, n_shards)
    tml = TRS(0.25, getattr(tt.CoarsenType, coarsen),
              getattr(tt.InterpType, interp))
    jml = JRS(0.25, getattr(jt.CoarsenType, coarsen),
              getattr(jt.InterpType, interp))
    for ml, A in ((tml, tA), (jml, jA)):
        ml.setup_mode = "distributed"
        ml.setup(A)
    assert tml.num_levels == jml.num_levels >= 3
    for lt, lj in zip(tml.levels, jml.levels):
        for f in ("A", "P"):
            t, j = getattr(lt, f), getattr(lj, f)
            assert (t is None) == (j is None)
            if t is None:
                continue
            _bytes_equal(t.global_csr, j.global_csr)
            for b in ("row_bounds", "col_bounds"):
                assert np.array_equal(getattr(t.partition, b),
                                      getattr(j.partition, b))
    assert [lvl for lvl, _, _ in tml.rap_stats] == \
        list(range(tml.num_levels - 1))
    for rec in tml.level_engines:
        assert rec == {"interp": "host", "interp_reason":
                       "setup_mode=distributed", "rap": "host",
                       "rap_reason": "setup_mode=distributed"}


def test_distributed_hmis_extended_one_shard_equals_global():
    tA, _ = _aniso(32, 1)
    mlg = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended)
    mlg.rap_mode = mlg.interp_mode = "host"
    mlg.setup(tA)
    mld = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended)
    mld.setup_mode = "distributed"
    mld.setup(tA)
    assert mld.num_levels == mlg.num_levels
    for lg, ld in zip(mlg.levels, mld.levels):
        _close(ld.A.global_csr, lg.A.global_csr, 1e-12)


@pytest.mark.parametrize("n_shards", [1, 8])
@pytest.mark.parametrize("coarsen,interp", [("CLJP", "ModClassical"),
                                            ("HMIS", "Extended")])
def test_distributed_setup_mode_solves(n_shards, coarsen, interp):
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    tA, _ = _aniso(40, n_shards)
    ml = TRS(0.25, getattr(tt.CoarsenType, coarsen),
             getattr(tt.InterpType, interp), relax_type=tt.RelaxType.SOR)
    ml.setup_mode = "distributed"
    ml.setup(tA)
    assert ml.num_levels >= 3
    dh = DeviceHierarchy(ml, device="cpu")
    b = tA.mult(np.ones(tA.global_num_rows))
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    assert r.n_iters < ml.max_iterations
    assert r.res[r.n_iters] < ml.solve_tol


@pytest.mark.parametrize("n_shards", [4, 8])
def test_local_view_matrix(n_shards):
    """A matrix rebuilt from its shards' global-column row blocks (the
    local view the distributed setup hands around) against JAX's."""
    tA, jA = _aniso(20, n_shards)
    rows = ttr.split_rows(tA.global_csr, tA.partition.row_bounds)
    view = ParCSRMatrix.from_local_rows(rows[1:], tA.partition,
                                        first_shard=1)
    jrows = jtr.split_rows(jA.global_csr, jA.partition.row_bounds)
    jview = jpm.ParCSRMatrix.from_local_rows(jrows[1:], jA.partition,
                                             first_shard=1)
    assert view.is_local_view and view.first_shard == 1
    assert view.local_nnz == jview.local_nnz
    for tb, jb, gb in zip(view.shards(), jview.shards(), tA.shards()[1:]):
        _bytes_equal(tb.on_proc, jb.on_proc)
        _bytes_equal(tb.off_proc, gb.off_proc)
        G = tA.global_num_cols
        _bytes_equal(tb.global_cols_csr(G), jb.global_cols_csr(G))
    with pytest.raises(RuntimeError, match="local-view"):
        view.nnz
    with pytest.raises(RuntimeError, match="every shard"):
        view.assemble_global()
    full = ParCSRMatrix.from_local_rows(rows, tA.partition)
    _bytes_equal(full.assemble_global(), tA.global_csr)


def test_dist_cljp_update_checks_in_place_arrays():
    """The native CLJP update writes four arrays in place: a copy made to
    fix a dtype or layout would leave the caller's state unchanged, so
    the binding refuses them."""
    n, h = 2, 1
    # row 1 is a new C point with one strong on-edge (to row 0) and one
    # off-edge (to halo column 0)
    args = dict(n=n, h=h, first_local_col=0, on_indptr=np.array([0, 0, 1]),
                on_indices=np.array([0]), off_indptr=np.array([0, 0, 1]),
                off_indices=np.array([0]), hp_indptr=np.array([0, 0]),
                hp_cols=np.zeros(0, dtype=np.int64), cmap=np.array([5]),
                st=np.array([-1, -1]), hstU=np.array([1]),
                sel=np.array([0, 1]), hnew=np.array([0]),
                edgemark_on=np.ones(1, dtype=np.int64),
                edgemark_off=np.ones(1, dtype=np.int64),
                w=np.array([3.0, 2.0]), off_dec=np.zeros(1))
    native.dist_cljp_update(**args)
    assert args["w"][0] == 2.0 and args["off_dec"][0] == -1.0
    assert args["edgemark_on"][0] == 0 and args["edgemark_off"][0] == 0
    for key, bad in (("edgemark_on", np.ones(1, dtype=np.int32)),
                     ("w", np.ones(4)[::2]),
                     ("off_dec", np.zeros(1, dtype=np.float32))):
        with pytest.raises(ValueError, match=key):
            native.dist_cljp_update(**{**args, key: bad})


# --- knobs the port does not run raise --------------------------------------

def _grid(n_shards=2):
    return tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (16, 16),
                                n_shards)


@pytest.mark.parametrize("knobs", [
    {"num_variables": 2, "variables": np.arange(256, dtype=np.int64) % 2},
    {"variables": np.zeros(256, dtype=np.int64)},
    {"sparsify_tol": 0.01}], ids=["num_variables", "variables",
                                  "sparsify_tol"])
def test_rs_systems_and_sparsify_run_in_global_mode(knobs):
    """The knobs that raised until systems AMG and RAP sparsification were
    ported now build JAX's global hierarchy bit for bit."""
    tml = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended)
    jml = JRS(0.25, jt.CoarsenType.HMIS, jt.InterpType.Extended)
    jml.rap_mode = jml.interp_mode = "host"
    for ml in (tml, jml):
        for k, v in knobs.items():
            setattr(ml, k, v)
    tml.setup(_grid())
    jml.setup(jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO),
                                   (16, 16), 2))
    assert tml.num_levels == jml.num_levels > 2
    for tl, jl in zip(tml.levels, jml.levels):
        _bytes_equal(tl.A.global_csr, jl.A.global_csr)
        if jl.P is not None:
            _bytes_equal(tl.P.global_csr, jl.P.global_csr)


def test_distributed_sparsify_raises():
    """The JAX package's distributed setup ignores ``sparsify_tol``; the
    port's refuses it before any level is built."""
    ml = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended)
    ml.setup_mode = "distributed"
    ml.sparsify_tol = 0.01
    with pytest.raises(NotImplementedError, match="sparsify_tol"):
        ml.setup(_grid())
    assert ml.levels == []


def test_unknown_setup_mode_raises():
    from raptor_tpu_torch import (ParBSRRugeStubenSolver,
                                  ParSmoothedAggregationSolver)
    for ml in (TRS(0.25), ParSmoothedAggregationSolver(0.25),
               ParBSRRugeStubenSolver(2, 0.25)):
        ml.setup_mode = "sharded"
        with pytest.raises(ValueError, match="setup_mode"):
            ml.setup(_grid())
        assert ml.levels == []


def test_distributed_symmetric_strength_raises():
    ml = TRS(0.25, strength_type=tt.StrengthType.Symmetric)
    ml.setup_mode = "distributed"
    with pytest.raises(NotImplementedError, match="classical"):
        ml.setup(_grid())
    assert ml.levels == []


def test_tap_amg_on_bsr_hierarchy_raises():
    from raptor_tpu_torch import BSRDeviceHierarchy, ParBSRRugeStubenSolver
    from raptor_tpu_torch.gallery.fem import par_fem
    A, _ = par_fem("elasticity", 6, 4, 2)
    ml = ParBSRRugeStubenSolver(2, 0.25)
    ml.setup(A)
    ml.tap_amg = 0
    with pytest.raises(NotImplementedError, match="tap_amg"):
        BSRDeviceHierarchy(ml, device="cpu")


def test_tap_amg_needs_a_matching_layout():
    from raptor_tpu_torch.device import par as tpar
    from raptor_tpu_torch.multilevel.device_hierarchy import DeviceHierarchy
    ml = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended)
    ml.setup(_grid(8))
    ml.tap_amg = 0
    for mesh in (None, tpar.make_mesh2(2, 2)):
        with pytest.raises(ValueError, match="make_mesh2"):
            DeviceHierarchy(ml, device="cpu", mesh=mesh)
