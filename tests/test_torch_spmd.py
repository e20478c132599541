"""The port's SPMD bridge against the JAX package's (tests/
test_spmd_bridge.py): the rank-local halo plan
(``comm.plan.build_comm_plan_spmd``), the whole-hierarchy per-rank setups
(``comm.spmd``: RS, SA, blocked) level by level, and
``DeviceHierarchy.from_spmd`` solving as JAX's ``from_spmd`` and as the
port's in-process route (``setup_mode = "distributed"`` then
``DeviceHierarchy``), with the plain and the topology-aware exchange, and
the per-rank vector placement. A rank's view of its one shard (threads
over a queue group) packs that shard's rows of the full stack.

The problems are JAX's: the rotated anisotropic diffusion on 40^2 (30^2
for SA) and 24 x 12 Q1 plane-stress elasticity; float64, b = A 1.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.comm import plan as jplan  # noqa: E402
from raptor_tpu.comm import spmd as jspmd  # noqa: E402
from raptor_tpu.comm.transport import (  # noqa: E402
    InProcessTransport as JIT)
from raptor_tpu.core import types as jt  # noqa: E402
from raptor_tpu.core.par_matrix import ParCSRMatrix as JPar  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.gallery.fem import par_fem as jpar_fem  # noqa: E402
from raptor_tpu.multilevel import bsr_hierarchy as jbh  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu_torch.comm import plan as tplan  # noqa: E402
from raptor_tpu_torch.comm import spmd as tspmd  # noqa: E402
from raptor_tpu_torch.comm import tap as ttap  # noqa: E402
from raptor_tpu_torch.comm.multiproc import (  # noqa: E402
    MultiProcessTransport)
from raptor_tpu_torch.comm.transport import (  # noqa: E402
    InProcessTransport as TIT, split_rows)
from raptor_tpu_torch.core import types as tt  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.device.relax import DeviceRelax as DeviceRelaxT  # noqa
from raptor_tpu_torch.device.relax import build_relax  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.multilevel import bsr_hierarchy as tbh  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as TDH)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as TRS)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_mc import run_threads  # noqa: E402
from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

SHARDS = [1, 4, 8]
RS_CONFIGS = [("HMIS", "Extended"), ("CLJP", "ModClassical")]
PLAN_ARRAYS = ("send_idx", "send_mask", "halo_src", "halo_mask",
               "slot_to_halo", "recv_mask", "n_halo")


@functools.lru_cache(maxsize=None)
def _aniso(n, n_shards):
    """(port, JAX) matrices of the n x n anisotropic problem, and the glibc
    weights."""
    tA = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (n, n),
                              n_shards)
    jA = jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO), (n, n),
                              n_shards)
    return tA, jA, form_rand_weights(tA.global_num_rows, 0)


def _close(t, j, atol=1e-12):
    """Two CSRs (either package): equal shape and pattern, values within
    ``atol`` relative to the largest."""
    assert (t.n_rows, t.n_cols) == (j.n_rows, j.n_cols)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    np.testing.assert_allclose(t.data, j.data, rtol=0,
                               atol=atol * max(1.0, np.abs(j.data).max()))


def _same_hierarchy(th, jh, atol=1e-12):
    """Two SpmdHierarchy level by level: the partitions and assembled
    operators (local views below the caller's fine matrix), each shard's
    P block, the states, the coarse LU."""
    assert th.num_levels == jh.num_levels >= 3
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        ta, ja = tl.a_local, jl.a_local
        assert ta.is_local_view == ja.is_local_view == (i > 0)
        for f in ("row_bounds", "col_bounds"):
            np.testing.assert_array_equal(getattr(ta.partition, f),
                                          getattr(ja.partition, f))
        _close(ta.assemble_global(), ja.assemble_global(), atol)
        assert (tl.p_blocks is None) == (jl.p_blocks is None)
        if tl.p_blocks is not None:
            for tp, jp in zip(tl.p_blocks, jl.p_blocks):
                _close(tp, jp, atol)
            np.testing.assert_array_equal(tl.states, jl.states)
    for t, j in zip(th.coarse_lu, jh.coarse_lu):
        np.testing.assert_allclose(t, j, rtol=0, atol=atol * max(
            1.0, np.abs(j).max()))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("lane_pad", [1, 128])
def test_comm_plan_spmd(n_shards, lane_pad):
    """The rank-local handshake plan equals the port's in-process plan and
    JAX's handshake plan."""
    tA, jA, _ = _aniso(40, n_shards)
    got = tplan.build_comm_plan_spmd(tA, TIT(tA), lane_pad=lane_pad)
    for ref in (tplan.build_comm_plan(tA, lane_pad=lane_pad),
                jplan.build_comm_plan_spmd(jA, JIT(jA), lane_pad=lane_pad)):
        assert (got.slot, got.halo_pad) == (ref.slot, ref.halo_pad)
        for f in PLAN_ARRAYS:
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                          f)


@functools.lru_cache(maxsize=None)
def _rs(coarsen, interp, n_shards=4):
    tA, jA, w = _aniso(40, n_shards)
    th = tspmd.spmd_rs_setup(tA, w, TIT, coarsen=getattr(tt.CoarsenType,
                                                         coarsen),
                             interp=getattr(tt.InterpType, interp))
    jh = jspmd.spmd_rs_setup(jA, w, JIT, coarsen=getattr(jt.CoarsenType,
                                                         coarsen),
                             interp=getattr(jt.InterpType, interp))
    return th, jh


@pytest.mark.parametrize("n_shards", [4, 8])
@pytest.mark.parametrize("coarsen,interp", RS_CONFIGS)
def test_spmd_rs_setup_matches_jax(coarsen, interp, n_shards):
    th, jh = _rs(coarsen, interp, n_shards)
    _same_hierarchy(th, jh)


@functools.lru_cache(maxsize=None)
def _sa(n_shards):
    tA, jA, w = _aniso(30, n_shards)
    return (tspmd.spmd_sa_setup(tA, w, TIT, theta=0.25),
            jspmd.spmd_sa_setup(jA, w, JIT, theta=0.25))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_spmd_sa_setup_matches_jax(n_shards):
    _same_hierarchy(*_sa(n_shards))


@functools.lru_cache(maxsize=None)
def _bsr(n_shards):
    """spmd_bsr_setup on 24 x 12 elasticity over a block-aligned partition
    (CLJP + modified classical, theta 0.25), in both packages."""
    out = []
    for fem, bh, spmd, it in ((par_fem, tbh, tspmd, TIT),
                              (jpar_fem, jbh, jspmd, JIT)):
        A, _ = fem("elasticity", 24, 12, n_shards)
        part = bh.block_partition(A.global_num_rows, A.global_num_cols, 2,
                                  n_shards)
        Ap = (ParCSRMatrix(A.global_csr, part) if fem is par_fem
              else JPar(A.global_csr, part))
        w = form_rand_weights(Ap.global_num_rows // 2, 0)
        out.append((Ap, spmd.spmd_bsr_setup(Ap, 2, w, it)))
    return out


@pytest.mark.parametrize("n_shards", [1, 4])
def test_spmd_bsr_setup_matches_jax_and_the_solver(n_shards):
    """Level by level equal to JAX's spmd_bsr_setup; and the assembled
    operators equal the port's distributed blocked solver's after a
    common 1e-14 drop (the solver re-partitions each coarse level evenly,
    the per-rank setup keeps its C-nodes' partition)."""
    (tA, th), (_, jh) = _bsr(n_shards)
    _same_hierarchy(th, jh)
    ml = tbh.ParBSRRugeStubenSolver(2, strong_threshold=0.25,
                                    coarsen_type=tt.CoarsenType.CLJP)
    ml.setup_mode = "distributed"
    ml.setup(tA)
    assert ml.num_levels == th.num_levels
    for lvl, sl in zip(ml.levels, th.levels):
        ref = lvl.A.global_csr.drop(1e-14)
        got = sl.a_local.assemble_global().drop(1e-14)
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.data, ref.data, rtol=1e-12,
                                   atol=1e-14)


def _solve(dh, b):
    r = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    return r, dh.host(r.x)


@pytest.mark.parametrize("coarsen,interp", RS_CONFIGS)
def test_from_spmd_matches_jax_and_the_classic_route(coarsen, interp):
    """Float64 Chebyshev V-cycles on the 4-shard 40^2 problem: JAX's
    from_spmd cycle count, solution within rtol 1e-10 of it; the same
    cycles and solution as the port's setup_mode="distributed" ->
    DeviceHierarchy route; vector_local equal to vector."""
    th, jh = _rs(coarsen, interp)
    tA, _, w = _aniso(40, 4)
    b = tA.mult(np.ones(tA.global_num_rows))
    dh = TDH.from_spmd(th, TIT, relax_type=tt.RelaxType.Chebyshev,
                       device="cpu")
    assert dh.lane_pad == 1 and dh.relax_kind == "chebyshev"
    r, x = _solve(dh, b)
    jdh = JDH.from_spmd(jh, jpar.make_mesh(4), JIT,
                        relax_type=jt.RelaxType.Chebyshev)
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    assert r.n_iters == int(jr.n_iters) > 3
    np.testing.assert_allclose(x, jdh.host(np.asarray(jr.x)), rtol=1e-10,
                               atol=1e-12)

    ml = TRS(0.25, getattr(tt.CoarsenType, coarsen),
             getattr(tt.InterpType, interp),
             relax_type=tt.RelaxType.Chebyshev)
    ml.setup_mode = "distributed"
    ml.weights = w
    ml.setup(tA)
    rc, xc = _solve(TDH(ml, device="cpu"), b)
    assert len(ml.levels) == len(dh.levels) and rc.n_iters == r.n_iters
    np.testing.assert_allclose(x, xc, rtol=1e-10, atol=1e-12)

    rb = tA.partition.row_bounds
    locs = [b[int(rb[s]):int(rb[s + 1])] for s in range(4)]
    assert torch.equal(dh.vector_local(locs), dh.vector(b))


def test_from_spmd_without_a_setup_object():
    """solve_mixed (float64 residuals through the transport-packed fine A)
    and precond_pack run on a from_spmd hierarchy, which holds no setup
    object: the classic route's refinements and preconditioned result."""
    th, _ = _rs("HMIS", "Extended")
    tA, _, w = _aniso(40, 4)
    b = tA.mult(np.ones(tA.global_num_rows))
    dh = TDH.from_spmd(th, TIT, relax_type=tt.RelaxType.Chebyshev,
                       dtype=torch.float32, device="cpu")
    ml = TRS(0.25, tt.CoarsenType.HMIS, tt.InterpType.Extended,
             relax_type=tt.RelaxType.Chebyshev)
    ml.setup_mode = "distributed"
    ml.weights = w
    ml.setup(tA)
    ref = TDH(ml, dtype=torch.float32, device="cpu")
    assert not hasattr(dh, "ml")
    (x, h), (xr, hr) = (d.solve_mixed(np.zeros_like(b), b, tol=1e-8)
                        for d in (dh, ref))
    assert len(h) == len(hr) and h[-1] < 1e-8
    np.testing.assert_allclose(h, hr, rtol=1e-5)
    bd = ref.vector(b).double()
    pre = [d.precond_pack()(torch.zeros_like(bd), bd) for d in (dh, ref)]
    assert pre[0].dtype == torch.float64
    np.testing.assert_allclose(pre[0].numpy(), pre[1].numpy(), rtol=0,
                               atol=1e-5 * pre[1].abs().max().item())


def test_from_spmd_sa_matches_jax():
    """The SA whole-hierarchy setup feeds the bridge: Chebyshev(2) to 1e-7
    in JAX's from_spmd cycle count."""
    th, jh = _sa(4)
    tA, _, _ = _aniso(30, 4)
    b = tA.mult(np.ones(tA.global_num_rows))
    dh = TDH.from_spmd(th, TIT, relax_type=tt.RelaxType.Chebyshev,
                       num_smooth_sweeps=2, device="cpu")
    r, x = _solve(dh, b)
    jdh = JDH.from_spmd(jh, jpar.make_mesh(4), JIT,
                        relax_type=jt.RelaxType.Chebyshev,
                        num_smooth_sweeps=2)
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    assert r.n_iters == int(jr.n_iters) < 60 and r.res[r.n_iters] < 1e-7
    np.testing.assert_allclose(x, jdh.host(np.asarray(jr.x)), rtol=1e-10,
                               atol=1e-12)


def test_from_spmd_tap_equals_plain_exchange():
    """tap_amg = 0 on the 2 x 4 layout: the topology-aware exchange on
    every level gives the plain exchange's cycles and solution; a layout
    of the wrong size raises."""
    th, _ = _rs("HMIS", "Extended", 8)
    tA, _, _ = _aniso(40, 8)
    b = tA.mult(np.ones(tA.global_num_rows))
    kw = dict(relax_type=tt.RelaxType.Chebyshev, device="cpu")
    plain = TDH.from_spmd(th, TIT, **kw)
    tap = TDH.from_spmd(th, TIT, mesh=tpar.make_mesh2(2, 4), tap_amg=0,
                        **kw)
    assert all(lvl.TA is not None for lvl in tap.levels)
    assert all(lvl.TP is not None for lvl in tap.levels[:-1])
    (r0, x0), (r1, x1) = _solve(plain, b), _solve(tap, b)
    assert r0.n_iters == r1.n_iters > 3
    np.testing.assert_allclose(x1, x0, rtol=0,
                               atol=1e-12 * np.abs(x0).max())
    with pytest.raises(ValueError, match="tap_amg"):
        TDH.from_spmd(th, TIT, mesh=tpar.make_mesh2(2, 2), tap_amg=0, **kw)


def _assert_rows(view, full, r, fields):
    """A one-shard view's packed tensors equal rank r's rows of the full
    stack's: every field (the offset lists and the scalars whole), the
    list that a view pads to its own largest count (BDIA's tile planes)
    up to its count."""
    for f in fields:
        got, want = getattr(view, f), getattr(full, f)
        if not isinstance(want, torch.Tensor):
            assert got == want, f
        elif f in ("dia_off", "bd_off"):      # one list for every shard
            assert torch.equal(got, want), f
        elif f == "bd_tplane":
            n = int(full.bd_tptr[r, -1])
            assert int(view.bd_tptr[0, -1]) == n
            assert torch.equal(got[:, :n], want[r:r + 1, :n]), f
        else:
            rows = want[:, r:r + 1] if f == "color_ok" else want[r:r + 1]
            assert torch.equal(got, rows), f


def _level_views(hier, rank):
    """Rank ``rank``'s one-shard views of an SPMD hierarchy's A and P."""
    out = []
    for i, lvl in enumerate(hier.levels):
        a = lvl.a_local
        ncols = a.partition.global_num_cols
        av = ParCSRMatrix.from_local_rows(
            [a.shards()[rank].global_cols_csr(ncols)], a.partition,
            first_shard=rank)
        pv = None
        if lvl.p_blocks is not None:
            part = a.partition
            cb = hier.levels[i + 1].a_local.partition.row_bounds
            part_p = Partition(part.global_num_rows, int(cb[-1]),
                                    part.n_shards, part.row_bounds, cb)
            pv = ParCSRMatrix.from_local_rows([lvl.p_blocks[rank]], part_p,
                                              first_shard=rank)
            pfull = ParCSRMatrix.from_local_rows(lvl.p_blocks, part_p)
            out.append((av, pv, a, pfull))
        else:
            out.append((av, None, a, None))
    return out


def test_partial_local_view_packs_its_rows():
    """Each of 4 ranks (threads over a queue group, a
    ``MultiProcessTransport`` each) packs only its own shard of every
    level: the matrices (A with lane pads 1 and 128, P embedded), the
    relaxation plans, ``put_stacked``, ``device_put_vector`` and
    ``vector_local`` equal that rank's rows of the full stack's. The
    topology-aware plan of a one-shard view without the controllers'
    comm raises (with it: tests/test_torch_mc_tap.py)."""
    import dataclasses
    th, _ = _rs("HMIS", "Extended", 4)
    tA, _, _ = _aniso(40, 4)
    b = tA.mult(np.ones(tA.global_num_rows))
    rb = tA.partition.row_bounds

    def pack(rank, group):
        out = []
        for av, pv, _, _ in _level_views(th, rank):
            tr = MultiProcessTransport(group, av)
            mats = [tpar.device_put_matrix(av, device="cpu", tr=tr,
                                           lane_pad=lp) for lp in (1, 128)]
            rx = build_relax(av, mats[0], need=("tri", "color"), tr=tr)
            if pv is not None:
                mats.append(tpar.device_put_matrix(
                    pv, device="cpu", tr=MultiProcessTransport(group, pv),
                    lane_pad=128, embed="cols"))
            out.append((mats, rx))
        with pytest.raises(ValueError, match="pass their comm"):
            ttap.device_put_tap(ttap.build_tap_plan(tA, 2, 2),
                                torch.float64, torch.device("cpu"),
                                first_shard=rank, n_local=1)
        return out

    packed = run_threads(4, pack)
    mfields = [f.name for f in dataclasses.fields(tpar.DeviceParCSR)]
    rfields = [f.name for f in dataclasses.fields(DeviceRelaxT)
               if f.name not in ("fwd", "bwd")]
    for r in range(4):
        for (mats, rx), (_, _, a, pfull) in zip(packed[r],
                                                _level_views(th, 0)):
            full = [tpar.device_put_matrix(a, device="cpu", tr=TIT(a),
                                           lane_pad=lp) for lp in (1, 128)]
            if pfull is not None:
                full.append(tpar.device_put_matrix(
                    pfull, device="cpu", tr=TIT(pfull), lane_pad=128,
                    embed="cols"))
            for m, fm in zip(mats, full):
                _assert_rows(m, fm, r, mfields)
            _assert_rows(rx, build_relax(a, full[0], need=("tri", "color"),
                                         tr=TIT(a)), r, rfields)
        ct = np.arange(32, dtype=np.int64).reshape(4, 8)
        assert torch.equal(
            tpar.put_stacked({"ct": ct[r:r + 1]}, 4, "cpu",
                             first_shard=r)["ct"],
            tpar.put_stacked({"ct": ct}, 4, "cpu")["ct"][r:r + 1])
        whole = tpar.device_put_vector(b, rb, 512, device="cpu")
        mine = b[int(rb[r]):int(rb[r + 1])]
        assert torch.equal(tpar.device_put_vector(
            mine, rb, 512, device="cpu", first_shard=r, n_local=1),
            whole[r:r + 1])
        assert torch.equal(tpar.device_put_vector_local(
            [mine], rb, 512, device="cpu", first_shard=r), whole[r:r + 1])
