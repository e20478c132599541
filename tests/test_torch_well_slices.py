"""The sliced windowed-ELL layout (``formats.well_slices``, packed by
``par.device_put_matrix`` as ``wl_perm``/``wl_sptr``/``wl_crel``/
``wl_cvals``) that the windowed-ELL kernel reads in place of the padded
``[W, R]`` arrays, on the forced ``well`` plans of the level-0 P (embedded
by columns) and P^T (by rows) of the 3-D 27-point Laplacian at 16^3, at 1
and 4 shards, with lane padding 128, in float32 and float64.

The layout holds every nonzero of the padded arrays once, in each row's
slot order, and nothing else; each slice is as wide as its longest row;
the columns are int16 exactly when the window fits. Its plain product
(``formats.well_slices_spmv``, the CPU path of the kernel) equals the
padded one and the JAX package's XLA and Pallas (interpret mode) versions
on the same packed arrays. Edge cases on synthetic layouts: an empty
tile, an empty shard, ``rows_pad`` not a multiple of 32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import formats as jfmt  # noqa: E402
from raptor_tpu.device import pallas_kernels as jpk  # noqa: E402
from raptor_tpu_torch.device import formats as tfmt  # noqa: E402
from raptor_tpu_torch.device import kernels  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402

from _torch_parity import jax_hierarchy3d, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

LANE = 128
SL = tfmt.WELL_SLICE
N = 16
# (operator, embedding the V-cycle asks for) x shards x dtype
CASES = [(op, embed, S, dt) for op, embed in (("P", "cols"), ("Pt", "rows"))
         for S in (1, 4) for dt in (torch.float32, torch.float64)]
IDS = [f"{op}-S{S}-{str(dt)[6:]}" for op, _, S, dt in CASES]


def _packed(op, embed, S, dtype):
    P = jax_hierarchy3d(N, S).levels[0].P
    tA = tpar.device_put_matrix(to_port(P if op == "P" else P.transpose()),
                                dtype=dtype, lane_pad=128, embed=embed,
                                force_format="well", need_transpose=False,
                                device="cpu")
    assert tA.on_format == "well"
    return tA


def _sliced(tA):
    return (tA.wl_ws, tA.wl_perm, tA.wl_sptr, tA.wl_crel, tA.wl_cvals)


def _padded_rows(ws, rel, vals, ba):
    """The nonzeros of a padded layout as a list per (shard, row): (absolute
    column, value) in slot order."""
    S, W, R = vals.shape
    out = {}
    for s in range(S):
        w, r = np.nonzero(vals[s])
        o = np.lexsort((w, r))
        for ri, wi in zip(r[o], w[o]):
            col = int(ws[s, ri // (ba * LANE)]) * LANE + int(rel[s, wi, ri])
            out.setdefault((s, int(ri)), []).append((col, vals[s, wi, ri]))
    return out


def _sliced_rows(ws, perm, sptr, crel, cvals, ba):
    """The entries of a sliced layout as a list per (shard, row), in slot
    order, up to each lane's last nonzero; checks that the rest of a lane
    is padding (value 0, column 0) and returns each slice's longest row."""
    S, R = perm.shape
    TR = ba * LANE
    out, longest = {}, []
    for s in range(S):
        longest.append([])
        assert not cvals[s, sptr[s, -1] * SL:].any()
        for k in range(R // SL):
            b0, b1 = int(sptr[s, k]), int(sptr[s, k + 1])
            c = crel[s, b0 * SL:b1 * SL].reshape(b1 - b0, SL)
            v = cvals[s, b0 * SL:b1 * SL].reshape(b1 - b0, SL)
            n = (v != 0).sum(axis=0)
            longest[s].append(int(n.max(initial=0)))
            for lane in range(SL):
                p = k * SL + lane
                tile = p // TR
                row = tile * TR + int(perm[s, p])
                m = int(n[lane])
                assert (v[:m, lane] != 0).all()
                assert not v[m:, lane].any() and not c[m:, lane].any()
                if m:
                    out[(s, row)] = [(int(ws[s, tile]) * LANE + int(ci), vi)
                                     for ci, vi in zip(c[:m, lane],
                                                       v[:m, lane])]
    return out, longest


def _np(*ts):
    return [t.numpy() for t in ts]


@pytest.mark.parametrize("op,embed,S,dtype", CASES, ids=IDS)
def test_every_nonzero_once_in_slot_order(op, embed, S, dtype):
    """Each row's sliced entries are its nonzeros of the padded layout, with
    the same absolute column and value, in slot order; no other entry of
    the sliced layout holds a value."""
    tA = _packed(op, embed, S, dtype)
    ws, rel, vals = _np(tA.wl_ws, tA.on_cols, tA.on_vals)
    want = _padded_rows(ws, rel, vals, tA.wl_ba)
    got, _ = _sliced_rows(*_np(*_sliced(tA)), tA.wl_ba)
    assert got == want
    assert sum(map(len, got.values())) == int((vals != 0).sum()) > 0


@pytest.mark.parametrize("op,embed,S,dtype", CASES, ids=IDS)
def test_slices_sorted_and_as_wide_as_longest_row(op, embed, S, dtype):
    """Within each tile the rows run by entry count, most first, ties by
    row; every row of the tile appears once; a slice's width is its
    longest row's count; the sliced layout holds no more slots than the
    padded one."""
    tA = _packed(op, embed, S, dtype)
    ws, perm, sptr, crel, cvals = _np(*_sliced(tA))
    vals = tA.on_vals.numpy()
    TR = tA.wl_ba * LANE
    _, longest = _sliced_rows(ws, perm, sptr, crel, cvals, tA.wl_ba)
    for s in range(S):
        np.testing.assert_array_equal(np.diff(sptr[s]), longest[s])
        cnt = (vals[s] != 0).sum(axis=0).reshape(-1, TR)
        order = perm[s].reshape(-1, TR).astype(np.int64)
        assert (np.sort(order, axis=1) == np.arange(TR)).all()
        sc = np.take_along_axis(cnt, order, axis=1)
        assert (np.diff(sc, axis=1) <= 0).all()
        tie = np.diff(sc, axis=1) == 0
        assert (np.diff(order, axis=1)[tie] > 0).all()
    nnz = int((vals != 0).sum())
    assert nnz <= int(sptr[:, -1].sum()) * SL <= vals.size


@pytest.mark.parametrize("op,embed,S,dtype", CASES, ids=IDS)
def test_column_width_follows_the_window(op, embed, S, dtype):
    """int16 columns exactly when ``WR * 128 <= 32768``: the packed window
    (8 to 32 blocks at 16^3) takes int16, and the same arrays read with a
    wider window take int32, with the same columns."""
    tA = _packed(op, embed, S, dtype)
    assert tA.wl_wr * LANE <= 1 << 15 and tA.wl_crel.dtype == torch.int16
    ws, rel, vals = _np(tA.wl_ws, tA.on_cols, tA.on_vals)
    for WR, cdt in ((256, np.int16), (264, np.int32)):
        perm, sptr, crel, cvals = tfmt.well_slices(ws, rel, vals, tA.wl_ba,
                                                   WR)
        assert crel.dtype == cdt
        np.testing.assert_array_equal(crel, tA.wl_crel.numpy())
        np.testing.assert_array_equal(cvals, tA.wl_cvals.numpy())


def _x(tA, seed):
    return np.random.default_rng(seed).standard_normal(
        (tA.n_shards, tA.cols_pad))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("op,embed,S,dtype", CASES, ids=IDS)
def test_sliced_product_equals_padded_and_jax(op, embed, S, dtype):
    """The sliced plain product against the padded one and JAX's XLA
    version (float64, 1e-12 relative), and against JAX's Pallas kernel in
    interpret mode (float32, 1e-5 relative), on the same packed arrays.
    The tolerances cover the summation order, which differs: each row's
    terms in slot order here, a vectorised sum over the slots there."""
    tA = _packed(op, embed, S, dtype)
    x = _x(tA, S)
    xt = torch.from_numpy(x).to(dtype)
    got = tfmt.well_slices_spmv(*_sliced(tA), xt, tA.wl_ba, tA.rows_pad)
    assert got.shape == (S, tA.rows_pad) and got.dtype == dtype
    assert torch.equal(got, kernels.wind_ell_spmv(*_sliced(tA), xt,
                                                  tA.wl_ba, tA.rows_pad))
    ws, rel, vals = _np(tA.wl_ws, tA.on_cols, tA.on_vals)
    if dtype == torch.float64:
        padded = tfmt.wind_ell_spmv(tA.wl_ws, tA.on_cols, tA.on_vals, xt,
                                    tA.wl_ba, tA.wl_wr, tA.rows_pad)
        assert _rel(got, padded) <= 1e-12
        for s in range(S):
            want = jfmt.wind_ell_spmv(jnp.asarray(ws[s]), jnp.asarray(rel[s]),
                                      jnp.asarray(vals[s]),
                                      jnp.asarray(x[s]), tA.wl_ba, tA.wl_wr,
                                      tA.rows_pad)
            assert _rel(got[s], want) <= 1e-12
    else:
        for s in range(S):
            want = jpk.wind_ell_spmv_pallas(
                jnp.asarray(ws[s]), jnp.asarray(rel[s]), jnp.asarray(vals[s]),
                jnp.asarray(x[s].astype(np.float32)), tA.wl_wr, tA.wl_ba,
                tA.rows_pad, jlo=jnp.asarray(tA.wl_jlo[s].numpy()),
                jhi=jnp.asarray(tA.wl_jhi[s].numpy()), interpret=True)
            assert _rel(got[s], want) <= 1e-5


def _synthetic(S, T, W, WR, rows_pad, C, seed, empty_tiles=(),
               empty_shards=()):
    """A random padded windowed-ELL layout (ba 8): rows of 0 to W entries
    spread over the W slots, as the packer spreads them; no entry in the
    tiles ``empty_tiles`` of every shard, the shards ``empty_shards`` or
    the rows from ``rows_pad`` on."""
    rng = np.random.default_rng(seed)
    TR = 8 * LANE
    R = T * TR
    cap = max(0, tfmt.wind_src_height(C, WR) - WR)
    ws = (rng.integers(0, cap + 1, (S, T)) & ~7).astype(np.int32)
    rel = rng.integers(0, WR * LANE, (S, W, R)).astype(np.int32)
    vals = rng.standard_normal((S, W, R))
    n = rng.integers(0, W + 1, (S, R))
    vals[rng.random((S, W, R)) * W >= n[:, None, :]] = 0.0
    for t in empty_tiles:
        vals[:, :, t * TR:(t + 1) * TR] = 0.0
    vals[list(empty_shards)] = 0.0
    vals[:, :, rows_pad:] = 0.0
    rel[vals == 0] = 0
    return ws, rel, vals, rng.standard_normal((S, C))


@pytest.mark.parametrize(
    "S,T,W,WR,rows_pad,C,empty_tiles,empty_shards",
    [(2, 3, 7, 16, 2 * 1024 + 77, 3000, (1,), ()),      # an empty tile
     (3, 2, 11, 8, 1500, 1400, (), (1,)),               # an empty shard
     (1, 2, 5, 24, 1029, 2900, (0,), ()),               # rows_pad % 32 = 5
     (2, 1, 83, 264, 1000, 40000, (), (0,))])           # int32 columns
def test_edge_cases(S, T, W, WR, rows_pad, C, empty_tiles, empty_shards):
    """Synthetic layouts: an empty tile gives zero-width slices, an empty
    shard a zero-entry shard beside a full one, a ragged rows_pad drops
    the rows past it; the sliced product equals the padded one."""
    ws, rel, vals, x = _synthetic(S, T, W, WR, rows_pad, C, S * 100 + W,
                                  empty_tiles, empty_shards)
    perm, sptr, crel, cvals = tfmt.well_slices(ws, rel, vals, 8, WR)
    assert crel.dtype == (np.int16 if WR * LANE <= 1 << 15 else np.int32)
    for t in empty_tiles:
        per = 1024 // SL
        assert not np.diff(sptr[:, t * per:(t + 1) * per + 1]).any()
    for s in empty_shards:
        assert sptr[s, -1] == 0
    assert cvals.shape[1] == max(1, int(sptr[:, -1].max())) * SL
    got, _ = _sliced_rows(ws, perm, sptr, crel, cvals, 8)
    assert got == _padded_rows(ws, rel, vals, 8)
    t = [torch.from_numpy(a) for a in (ws, perm, sptr, crel, cvals, x)]
    out = tfmt.well_slices_spmv(*t, 8, rows_pad)
    want = tfmt.wind_ell_spmv(*(torch.from_numpy(a) for a in (ws, rel, vals,
                                                               x)),
                              8, WR, rows_pad)
    assert out.shape == (S, rows_pad)
    assert _rel(out, want) <= 1e-12
    for s in empty_shards:
        assert not out[s].any()
