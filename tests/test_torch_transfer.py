"""Parity of the port's transfer formats with the JAX package's: windowed
ELL ("well"), the sorted-scatter transpose ("wellt") and BELL ("bell").

The NumPy packers byte for byte, whole plans under ``force_format``, the
plain SpMVs (the CPU path of the CUDA kernels) against JAX's XLA versions
in float64 and against its Pallas kernels in interpret mode in float32,
the port's byte rule, and a 3-D solve with every transfer operator in
each format. The operators are level 0 and 1 of the 16^3 27-point
PMIS + extended+i hierarchy at 1 and 4 shards. JAX runs on the CPU mesh of
tests/conftest.py.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core.matrix import CSRMatrix as JCSR  # noqa: E402
from raptor_tpu.device import formats as jfmt  # noqa: E402
from raptor_tpu.device import pallas_kernels as jpk  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix as TCSR  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.device import formats as tfmt  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)

from _torch_parity import (  # noqa: E402
    assert_same_history, jax_hierarchy3d, jax_solve3d, rhs, to_port)
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N = 16
SHARDS = [1, 4]
FORMATS = ["well", "wellt", "bell"]
# (name, level, operator, embedding the V-cycle asks for)
OPERATORS = [("P0", 0, "P", "cols"), ("Pt0", 0, "Pt", "rows"),
             ("P1", 1, "P", "cols")]

# fields of the JAX plan the port carries, compared value for value
_FIELDS = ["on_cols", "on_vals", "off_rows", "off_cols", "off_vals",
           "dia_vals", "bd_idx", "bd_vals", "bl_src", "bl_idx", "bl_vals",
           "rest_rows", "rest_cols", "rest_vals", "emb_idx", "emb_mask",
           "wl_ws", "wl_jlo", "wl_jhi", "send_idx", "send_mask", "halo_src",
           "slot_to_halo", "recv_mask", "row_mask"]
_META = ["rows_pad", "cols_pad", "halo_pad", "dia_pad", "dia_offsets",
         "bd_offsets", "bd_padb", "bd_ba", "wl_wr", "wl_ba", "on_format",
         "embed_kind", "on_rows_pad", "has_t", "global_num_rows",
         "global_num_cols"]


def _host_matrix(S, level, op):
    lvl = jax_hierarchy3d(N, S).levels[level]
    return lvl.P if op == "P" else lvl.P.transpose()


def _assert_bytes_equal(j_arrays, t_arrays):
    for a, b in zip(j_arrays, t_arrays, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed", OPERATORS)
def test_packers_byte_equal(S, name, level, op, embed):
    """Each NumPy packer, called on the same blocks, returns the same
    bytes in both packages."""
    m = _host_matrix(S, level, op)
    for jb, tb in zip(m.shards(), to_port(m).shards()):
        j_on, t_on = jb.on_proc, tb.on_proc
        R = -(-j_on.n_rows // 128) * 128 + 40
        C = j_on.n_cols + 3
        stats = jfmt.wind_ell_stats(j_on, R, 8)
        assert tfmt.wind_ell_stats(t_on, R, 8) == stats
        W, WR = stats[0], stats[1]
        for c in (1, C, 5000):
            assert tfmt.wind_src_height(c, WR) == jfmt.wind_src_height(c, WR)
        for dt in (np.float32, np.float64):
            _assert_bytes_equal(
                jfmt.wind_ell_arrays(j_on, R, W, WR, 8, C, dtype=dt),
                tfmt.wind_ell_arrays(t_on, R, W, WR, 8, C, dtype=dt))
        jT, tT = j_on.transpose(), t_on.transpose()
        T, Kp = jfmt.swellt_stats(jT)
        assert tfmt.swellt_stats(tT) == (T, Kp)
        assert tfmt.swellt_height(j_on.n_rows) == \
            jfmt.swellt_height(j_on.n_rows)
        _assert_bytes_equal(jfmt.swellt_arrays(jT, Kp, dtype=np.float32),
                            tfmt.swellt_arrays(tT, Kp, dtype=np.float32))
        wb, n_slots = jfmt.bell_stats(j_on)
        assert tfmt.bell_stats(t_on) == (wb, n_slots)
        a128 = -(-j_on.n_rows // 128) + 1
        _assert_bytes_equal(jfmt.bell_arrays(j_on, a128, wb, np.float64),
                            tfmt.bell_arrays(t_on, a128, wb, np.float64))


def _pair(S, lane_pad, level, op, embed, force, need_transpose=True):
    """The same matrix packed by both packages."""
    m = _host_matrix(S, level, op)
    jA = jpar.device_put_matrix(m, jpar.make_mesh(S), dtype=jnp.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=force,
                                need_transpose=need_transpose)
    tA = tpar.device_put_matrix(to_port(m), dtype=torch.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=force,
                                need_transpose=need_transpose, device="cpu")
    return m, jA, tA


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("lane_pad", [1, 128])
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed", OPERATORS[:2])
def test_forced_plan_equals_jax(S, lane_pad, name, level, op, embed, fmt):
    """A forced format packs the whole plan as JAX does, byte for byte; a
    forced bell keeps the embedding (well and wellt drop it)."""
    _, jA, tA = _pair(S, lane_pad, level, op, embed, fmt)
    assert tA.on_format == fmt
    for f in _META:
        assert getattr(tA, f) == getattr(jA, f), f
    for f in _FIELDS:
        j = np.asarray(getattr(jA, f))
        t = getattr(tA, f).numpy()
        assert t.shape == j.shape, f
        if j.dtype.kind == "f":
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), f
        else:   # ELL index arrays are int64 in the port
            np.testing.assert_array_equal(t, j, err_msg=f)
    if fmt in ("well", "wellt"):
        assert tA.on_cols.dtype == torch.int32    # the kernels' layout


_LAYOUT = {"ell": ("on_cols", "on_vals"),
           "well": ("on_cols", "on_vals", "wl_ws"),
           "wellt": ("on_cols", "on_vals", "wl_ws"),
           "bell": ("bl_src", "bl_idx", "bl_vals")}


@pytest.mark.parametrize("fmt", FORMATS + ["ell"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed", OPERATORS[:2])
def test_packed_bytes_is_the_layout(S, dtype, name, level, op, embed, fmt):
    """The byte count the format rule ranks by (``_transfer_bytes``, via
    ``packed_bytes``) is the size of the arrays the packer lays out."""
    tA = tpar.device_put_matrix(to_port(_host_matrix(S, level, op)),
                                dtype=dtype, lane_pad=128, embed=embed,
                                force_format=fmt, device="cpu")
    assert tA.on_format == fmt
    want = sum(getattr(tA, f).numel() * getattr(tA, f).element_size()
               for f in _LAYOUT[fmt])
    assert tpar.packed_bytes(tA) == want


def _rel(t, j):
    j = np.asarray(j)
    return float(np.abs(t.numpy() - j).max() / max(np.abs(j).max(), 1e-300))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed", OPERATORS)
def test_spmv_matches_jax(S, name, level, op, embed, fmt):
    """spmv, residual and spmv_T in float64 through each format: the port's
    plain versions against JAX's XLA versions, to 1e-12."""
    m, jA, tA = _pair(S, 128, level, op, embed, fmt)
    rng = np.random.default_rng(level * 10 + S)
    part = m.partition
    x = rng.standard_normal(part.global_num_cols)
    y = rng.standard_normal(part.global_num_rows)
    mesh = jpar.make_mesh(S)
    jx = jpar.device_put_vector(x, part.col_bounds, jA.cols_pad, mesh)
    jy = jpar.device_put_vector(y, part.row_bounds, jA.rows_pad, mesh)
    tx = tpar.device_put_vector(x, part.col_bounds, tA.cols_pad,
                                device="cpu")
    ty = tpar.device_put_vector(y, part.row_bounds, tA.rows_pad,
                                device="cpu")
    assert _rel(tpar.spmv(tA, tx), jpar.spmv(mesh, jA, jx)) <= 1e-12
    assert _rel(tpar.residual(tA, tx, ty),
                jpar.residual(mesh, jA, jx, jy)) <= 1e-12
    assert _rel(tpar.spmv_T(tA, ty), jpar.spmv_T(mesh, jA, jy)) <= 1e-12
    want = m.global_csr.to_scipy() @ x
    got = tpar.host_vector(tpar.spmv(tA, tx), part.row_bounds)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


# --- the plain versions against the Pallas kernels (interpret mode, f32) ------

def _close32(t, j):
    """max |port - pallas| <= 1e-5 max |pallas|: both sum in float32, in
    different orders."""
    j = np.asarray(j, dtype=np.float64)
    return np.abs(t.numpy().astype(np.float64) - j).max() <= \
        1e-5 * np.abs(j).max()


def test_plain_well_matches_pallas_interpret():
    """The shapes of tests/test_par_spmv.py:319: a banded operator with
    highly variable row lengths, empty (tile, slot) pairs and a ragged
    row tail."""
    rng = np.random.default_rng(7)
    n, ba = 3000, 8
    diags = {o: rng.random(n) * (rng.random(n) > 0.6)
             for o in (-900, -128, -5, 0, 3, 130, 890)}
    m = sp.diags(list(diags.values()), list(diags.keys()), shape=(n, n),
                 format="csr")
    m.eliminate_zeros()
    m.sort_indices()
    a = JCSR.from_scipy(m)
    W, WR, T, _ = jfmt.wind_ell_stats(a, n, ba)
    ws, rel, vals, jlo, jhi = jfmt.wind_ell_arrays(a, n, W, WR, ba, n,
                                                   dtype=np.float32)
    x = rng.random(n).astype(np.float32)
    want = jpk.wind_ell_spmv_pallas(
        jnp.asarray(ws), jnp.asarray(rel), jnp.asarray(vals), jnp.asarray(x),
        WR, ba, n, jlo=jnp.asarray(jlo), jhi=jnp.asarray(jhi),
        interpret=True)
    got = tfmt.wind_ell_spmv(torch.from_numpy(ws)[None],
                             torch.from_numpy(rel)[None],
                             torch.from_numpy(vals)[None],
                             torch.from_numpy(x)[None], ba, WR, n)[0]
    assert _close32(got, want)


@pytest.mark.parametrize("nf,nc", [(5000, 700), (2200, 180)])
def test_plain_swellt_matches_pallas_interpret(nf, nc):
    """The shapes of tests/test_par_spmv.py:241: restriction-shaped
    operators with ragged tails; the forward swellt_spmv against JAX's."""
    rng = np.random.default_rng(7)
    indptr, idx, dat = [0], [], []
    for r in range(nf):
        c0 = int(r * nc / nf)
        cs = np.unique(np.clip(
            c0 + rng.integers(-6, 7, size=rng.integers(1, 10)), 0, nc - 1))
        idx.extend(cs.tolist())
        dat.extend(rng.standard_normal(len(cs)).tolist())
        indptr.append(len(idx))
    B = JCSR(nf, nc, np.array(indptr), np.array(idx), np.array(dat))
    T, Kp = jfmt.swellt_stats(B)
    meta, vals, qb = jfmt.swellt_arrays(B, Kp, dtype=np.float32)
    x = rng.standard_normal(nf).astype(np.float32)
    want = jpk.swellt_spmv_T_pallas(jnp.asarray(meta), jnp.asarray(vals),
                                    jnp.asarray(qb), jnp.asarray(x), nc,
                                    interpret=True)
    tm, tv, tq = (torch.from_numpy(v)[None] for v in (meta, vals, qb))
    got = tfmt.swellt_spmv_T(tm, tv, tq, torch.from_numpy(x)[None], nc)[0]
    assert _close32(got, want)
    xc = rng.standard_normal(nc).astype(np.float32)
    want_f = jfmt.swellt_spmv(jnp.asarray(meta), jnp.asarray(vals),
                              jnp.asarray(qb), jnp.asarray(xc), nf)
    got_f = tfmt.swellt_spmv(tm, tv, tq, torch.from_numpy(xc)[None], nf)[0]
    assert _close32(got_f, want_f)


@pytest.mark.parametrize("n", [700, 1024])
def test_plain_bell_matches_pallas_interpret(n):
    """The shapes of tests/test_par_spmv.py:288: an unstructured operator
    with and without a ragged last block."""
    rng = np.random.default_rng(11)
    m = sp.random(n, n, density=0.02, random_state=5, format="csr")
    m = (m + sp.diags(np.ones(n))).tocsr()
    m.sort_indices()
    a = JCSR.from_scipy(m)
    a128 = -(-n // 128)
    wb, _ = jfmt.bell_stats(a)
    src, idx, vals = jfmt.bell_arrays(a, a128, wb, dtype=np.float32)
    x = rng.random(n).astype(np.float32)
    want = jpk.bell_spmv_pallas(jnp.asarray(src), jnp.asarray(idx),
                                jnp.asarray(vals), jnp.asarray(x),
                                a128 * 128, interpret=True)
    got = tfmt.bell_spmv(*(torch.from_numpy(v)[None]
                           for v in (src, idx, vals, x)), a128 * 128)[0]
    assert _close32(got, want)


# --- the byte rule -------------------------------------------------------------

def _expected_pick(m, lane_pad, itemsize):
    """The byte rule's pick for an ELL-headed matrix, from JAX's stats:
    the format whose packed arrays one apply streams are fewest."""
    part = m.partition
    R = -(-part.max_local_rows // lane_pad) * lane_pad
    C = -(-part.max_local_cols // lane_pad) * lane_pad
    blocks = [s.on_proc for s in m.shards()]
    W = max(int(np.diff(b.indptr).max(initial=0)) for b in blocks)
    cost = {"ell": max(1, W) * R * (8 + itemsize)}
    if R >= 2048:
        wW = max(jfmt.wind_ell_stats(b, R, 8)[0] for b in blocks)
        T = -(-R // 1024)
        cost["well"] = wW * T * 1024 * (4 + itemsize) + 4 * T
    if part.global_num_rows < part.global_num_cols and C >= 2048:
        st = [jfmt.swellt_stats(b.transpose()) for b in blocks]
        T, Kp = max(t for t, _ in st), max(k for _, k in st)
        cost["wellt"] = T * Kp * 128 * (4 + itemsize) + 4 * T * Kp
    if part.global_num_rows > part.global_num_cols:
        wb = max(jfmt.bell_stats(b)[0] for b in blocks)
        a128 = -(-R // 128)
        if wb > 0 and a128 > 2:
            cost["bell"] = wb * a128 * 128 * (1 + itemsize) + 4 * wb * a128
    return min(cost, key=lambda f: (cost[f], f)), cost


def _synthetic_restriction():
    """A 3-D-like prolongator whose >256 block offsets defeat BDIA
    (tests/test_par_spmv.py:203): P (34000 x 265) and P^T."""
    rng = np.random.default_rng(5)
    nf, nc = 34000, 265
    rows, cols = [], []
    for r in range(nf):
        c0 = int(r * nc / nf)
        cs = np.unique(np.clip(c0 + rng.integers(-3, 4, size=4), 0, nc - 1))
        cols.extend(cs.tolist())
        rows.extend([r] * len(cs))
    p = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(nf, nc))
    return p


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", ["P", "Pt"])
def test_byte_rule_on_synthetic_transfer(op, dtype):
    """An ELL-headed prolongator takes windowed ELL and its transpose the
    sorted-scatter layout: the formats with the fewest bytes."""
    from raptor_tpu.core.par_matrix import ParCSRMatrix as JPar
    from raptor_tpu.core.partition import Partition as JPart
    p = _synthetic_restriction()
    m = p if op == "P" else p.T.tocsr()
    m.sort_indices()
    args = (m.shape[0], m.shape[1], m.indptr.astype(np.int64),
            m.indices.astype(np.int64), m.data)
    jm = JPar(JCSR(*args), JPart.create(m.shape[0], m.shape[1], 1))
    tm = ParCSRMatrix(TCSR(*args), Partition.create(m.shape[0], m.shape[1],
                                                    1))
    itemsize = torch.empty(0, dtype=dtype).element_size()
    want, cost = _expected_pick(jm, 128, itemsize)
    assert want == {"P": "well", "Pt": "wellt"}[op], cost
    tA = tpar.device_put_matrix(tm, dtype=dtype, lane_pad=128,
                                need_transpose=False, device="cpu")
    assert tA.on_format == want and tA.embed_kind == "none"


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed", OPERATORS)
def test_byte_rule_on_3d_transfer(monkeypatch, S, name, level, op, embed):
    """The 3-D P and P^T at lane_pad 128: BDIA, as the structural rule
    has it at this size; with the BDIA planes refused, ELL-headed, and then the format
    of the fewest streamed bytes among those their shape admits."""
    m = _host_matrix(S, level, op)
    tA = tpar.device_put_matrix(to_port(m), dtype=torch.float32,
                                lane_pad=128, embed=embed,
                                need_transpose=False, device="cpu")
    assert tA.on_format in ("dia", "bdia")
    monkeypatch.setattr(tpar, "select_planes", lambda *a: [])
    want, cost = _expected_pick(m, 128, 4)
    tA = tpar.device_put_matrix(to_port(m), dtype=torch.float32,
                                lane_pad=128, embed=embed,
                                need_transpose=False, device="cpu")
    assert tA.on_format == want, cost
    if want == "bell":
        assert tA.embed_kind == "none"   # an automatic bell is un-embedded


# --- a solve through the transfer formats ----------------------------------------

def _port_hierarchy3d(S, lane_pad, p_fmt=None, pt_fmt=None):
    from raptor_tpu_torch.core.types import (CoarsenType, InterpType,
                                             RelaxType)
    from raptor_tpu_torch.gallery import stencils as tst
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 2
    ml.setup(tst.par_stencil_grid(tst.laplace_stencil_27pt(), (N, N, N), S))
    dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=lane_pad,
                         device="cpu")
    if p_fmt is not None:
        # every level's P and P^T packed as the V-cycle packs them, with
        # the embedding asked for, in the forced format
        kw = dict(dtype=torch.float64, lane_pad=lane_pad,
                  need_transpose=False, device="cpu")
        levels = []
        for lvl, hl in zip(dh.levels, ml.levels):
            if hl.P is not None:
                lvl = dataclasses.replace(
                    lvl,
                    P=tpar.device_put_matrix(hl.P, embed="cols",
                                             force_format=p_fmt, **kw),
                    Pt=tpar.device_put_matrix(hl.P.transpose(),
                                              embed="rows",
                                              force_format=pt_fmt, **kw))
            levels.append(lvl)
        dh.levels = tuple(levels)
    return ml, dh


@pytest.mark.parametrize("p_fmt,pt_fmt", [(None, None), ("well", "wellt"),
                                          ("bell", "well"),
                                          ("well", "bell")])
def test_solve_through_transfer_formats_like_jax(p_fmt, pt_fmt):
    """The f64 solve of the 3-D hierarchy, one shard at lane_pad 128, with
    the automatic formats and with every P and P^T forced into the
    transfer formats: JAX's cycles and residual history each time."""
    ml, dh = _port_hierarchy3d(1, 128, p_fmt, pt_fmt)
    if p_fmt is not None:
        assert {(lv.P.on_format, lv.Pt.on_format)
                for lv in dh.levels[:-1]} == {(p_fmt, pt_fmt)}
    b = rhs(ml)
    dh.solve_tol = 1e-9
    tr = dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))
    assert_same_history(tr, jax_solve3d(N, 1, 128))
