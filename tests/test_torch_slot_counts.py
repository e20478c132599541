"""The slot counts of the BELL and sorted-scatter kernels
(``formats.bell_counts`` and ``formats.swellt_counts``, packed by
``par.device_put_matrix`` as ``bl_cnt`` and ``wl_cnt``) on the forced
``bell`` and ``wellt`` plans of the level-0 P and P^T of the 3-D 27-point
Laplacian at 16^3, at 1 and 4 shards, with lane padding 128.

The counts are the kernels' precondition: every nonzero lies below its
slot's count, and the kernels read nothing past it. Both are held here, on
the CPU, by PyTorch emulations of the kernels' sums against the plain
``formats.bell_spmv`` and ``formats.swellt_spmv_T``: the BELL sum over the
counted slots, and the sorted-scatter sum over the counted entries, summed
per group of source tiles in a shared window and then flushed, at several
launch shapes (the kernel's own is a constant of its source). The packed
arrays stay byte-equal to the JAX package's, and the counts are the same
for the float32 and the float64 pack.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu_torch.device import formats as tfmt  # noqa: E402
from raptor_tpu_torch.device import kernels  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402

from _torch_parity import jax_hierarchy3d, to_port  # noqa: E402

LANE = 128
N = 16
# (operator, embedding the V-cycle asks for) x shards x forced format
CASES = [(op, embed, S, fmt) for op, embed in (("P", "cols"), ("Pt", "rows"))
         for S in (1, 4) for fmt in ("bell", "wellt")]
# (source tiles a CTA sums, 128-blocks of its window) of the emulated
# sorted-scatter sum
WELLT_SHAPES = ((1, 32), (4, 64), (32, 64))
# the arrays of each layout that the JAX package packs too
_LAYOUT = {"bell": ("bl_src", "bl_idx", "bl_vals"),
           "wellt": ("on_cols", "on_vals", "wl_ws")}


def _host_matrix(S, op):
    P = jax_hierarchy3d(N, S).levels[0].P
    return P if op == "P" else P.transpose()


def _packed(op, embed, S, fmt, dtype=torch.float64):
    tA = tpar.device_put_matrix(to_port(_host_matrix(S, op)), dtype=dtype,
                                lane_pad=128, embed=embed, force_format=fmt,
                                need_transpose=False, device="cpu")
    assert tA.on_format == fmt
    return tA


def _x(tA, seed):
    """A random x of the length the on-block kernel reads."""
    C = tA.rows_pad if tA.embed_kind == "cols" else tA.cols_pad
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (tA.n_shards, C)))


def _bell_counted(tA, x):
    """What the BELL kernel computes: out[s, a*128 + l] += vals[s,w,a,l] *
    x[s, src[s,w,a]*128 + idx[s,w,a,l]] over the slots w < bl_cnt[s, a]
    only, x zero outside [0, C)."""
    S, W, A128, _ = tA.bl_vals.shape
    C = x.shape[1]
    real = torch.arange(W)[None, :, None] < tA.bl_cnt[:, None, :]
    s, w, a = real.nonzero(as_tuple=True)
    j = tA.bl_src[s, w, a].long()[:, None] * LANE + tA.bl_idx[s, w, a].long()
    xv = torch.where((j >= 0) & (j < C), x[s[:, None], j.clamp(0, C - 1)],
                     0.0)
    out = torch.zeros((S * A128, LANE), dtype=x.dtype)
    out.index_add_(0, s * A128 + a, tA.bl_vals[s, w, a] * xv)
    return out.reshape(S, -1)[:, :tA.on_rows_pad]


def _wellt_grouped(tA, x, G, span):
    """What the sorted-scatter kernel computes, and how many global atomic
    adds it issues: per group of ``G`` consecutive source tiles of a shard,
    the entries below each slot's count (value nonzero, target below n_out)
    go into a window of ``span`` 128-blocks from the least window base of
    the group's counted slots, or straight to the output when outside it;
    then each nonzero window entry is added to the output."""
    S, T, KL = tA.on_vals.shape
    Kp, n_out, C = KL // LANE, tA.rows_pad, x.shape[1]
    span *= LANE
    cnt = tA.wl_cnt.reshape(S, T, Kp).long()
    qb = tA.wl_ws.reshape(S, T, Kp).long()
    m = tA.on_cols.reshape(S, T, Kp, LANE).long()
    v = tA.on_vals.reshape(S, T, Kp, LANE)
    srcl, qrel, lout = m & 127, (m >> 7) & 31, (m >> 12) & 127
    tgt = (qb[..., None] + qrel) * LANE + lout
    src = torch.arange(T)[:, None, None] * LANE + srcl
    out = torch.zeros((S, n_out), dtype=x.dtype)
    atomics = 0
    for s in range(S):
        for t0 in range(0, T, G):
            tiles = slice(t0, min(T, t0 + G))
            c, q = cnt[s, tiles], qb[s, tiles]
            if not (c > 0).any():
                continue
            lo = int(q[c > 0].min()) * LANE
            live = ((torch.arange(LANE) < c[..., None])
                    & (v[s, tiles] != 0) & (tgt[s, tiles] < n_out))
            g, xs = tgt[s, tiles][live], src[s, tiles][live]
            contrib = v[s, tiles][live] * torch.where(
                xs < C, x[s, xs.clamp(max=C - 1)], 0.0)
            inside = (g >= lo) & (g < lo + span)
            out[s].index_add_(0, g[~inside], contrib[~inside])
            acc = torch.zeros(span, dtype=x.dtype)
            acc.index_add_(0, g[inside] - lo, contrib[inside])
            hit = acc.nonzero(as_tuple=True)[0]
            out[s].index_add_(0, lo + hit, acc[hit])
            atomics += int((~inside).sum()) + len(hit)
    return out, atomics


@pytest.mark.parametrize("op,embed,S,fmt", CASES)
def test_counts_cover_every_nonzero(op, embed, S, fmt):
    """Each count is 1 + the last slot (BELL) or lane (sorted scatter) that
    holds a nonzero: nothing nonzero lies past it, and the real slots and
    entries before it are a prefix, as the packers fill them."""
    tA = _packed(op, embed, S, fmt)
    if fmt == "bell":
        cnt, W = tA.bl_cnt, tA.bl_vals.shape[1]
        assert cnt.dtype == torch.int32
        assert cnt.shape == (S, tA.bl_vals.shape[2])
        nz = (tA.bl_vals != 0).any(dim=3)                  # [S, W, A128]
        pos = torch.arange(W)[None, :, None].expand_as(nz)
        past = pos >= cnt[:, None, :]
    else:
        T, KL = tA.on_vals.shape[1:]
        cnt = tA.wl_cnt
        assert cnt.dtype == torch.int32
        assert cnt.shape == tA.wl_ws.shape == (S, T * KL // LANE)
        nz = (tA.on_vals != 0).reshape(S, -1, LANE)        # [S, T*Kp, 128]
        pos = torch.arange(LANE)[None, None, :].expand_as(nz)
        past = pos >= cnt[:, :, None]
        # the padding carries meta 0 and the unused slots base 0 as well
        assert not tA.on_cols.reshape(S, -1, LANE)[past].any()
        assert not tA.wl_ws[cnt == 0].any()
        nz = nz.transpose(1, 2)                            # [S, 128, T*Kp]
        past = past.transpose(1, 2)
    assert not nz[past].any()
    assert torch.equal(nz.sum(dim=1), cnt.long())           # a prefix
    assert int(cnt.sum()) > 0


@pytest.mark.parametrize("op,embed,S,fmt", CASES)
def test_counted_sum_equals_plain(op, embed, S, fmt):
    """The kernel's sum over the counted slots / entries equals the plain
    version's sum over the whole layout, to 1e-12 relative in float64 (the
    order of the sum differs); at each launch shape the sorted-scatter sum
    issues fewer global atomics than it has nonzeros, as many as
    ``kernels.swellt_modelled_global_atomics`` counts."""
    tA = _packed(op, embed, S, fmt)
    x = _x(tA, S)
    if fmt == "bell":
        want = tfmt.bell_spmv(tA.bl_src, tA.bl_idx, tA.bl_vals, x,
                              tA.on_rows_pad)
        sums = [_bell_counted(tA, x)]
    else:
        want = tfmt.swellt_spmv_T(tA.on_cols, tA.on_vals, tA.wl_ws, x,
                                  tA.rows_pad)
        nnz = int((tA.on_vals != 0).sum())
        sums = []
        for G, span in WELLT_SHAPES:
            got, atomics = _wellt_grouped(tA, x, G, span)
            assert atomics == kernels.swellt_modelled_global_atomics(
                tA.on_cols, tA.on_vals, tA.wl_ws, tA.wl_cnt, tA.rows_pad,
                G, span)
            assert 0 < atomics < nnz
            sums.append(got)
    for got in sums:
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


@pytest.mark.parametrize("op,embed,S,fmt", CASES)
def test_layout_equals_jax_and_counts_equal_across_types(monkeypatch, op,
                                                         embed, S, fmt):
    """The counts leave the packed layout as it was (byte-equal to the JAX
    package's), and the float32 pack counts the same slots."""
    monkeypatch.setenv("RAPTOR_TPU_WELL", "0")
    jA = jpar.device_put_matrix(_host_matrix(S, op), jpar.make_mesh(S),
                                dtype=jnp.float64, lane_pad=128, embed=embed,
                                force_format=fmt, need_transpose=False)
    tA = _packed(op, embed, S, fmt)
    for f in _LAYOUT[fmt]:
        t, j = getattr(tA, f).numpy(), np.asarray(getattr(jA, f))
        assert t.dtype == j.dtype and t.shape == j.shape, f
        assert t.tobytes() == j.tobytes(), f
    t32 = _packed(op, embed, S, fmt, torch.float32)
    assert torch.equal(t32.bl_cnt, tA.bl_cnt)
    assert torch.equal(t32.wl_cnt, tA.wl_cnt)


def test_other_formats_carry_empty_counts():
    """A plan of another format carries the counts' empty [S, 1]."""
    tA = _packed("P", "cols", 1, "wellt")
    assert tA.bl_cnt.shape == (1, 1) and not tA.bl_cnt.any()
    tA = _packed("P", "cols", 1, "bell")
    assert tA.wl_cnt.shape == (1, 1) and not tA.wl_cnt.any()


def test_counts_on_synthetic_layouts():
    """Counts of a hand-made BELL and sorted-scatter layout: an empty
    block, a zero slot between real ones, an unused slot."""
    vals = np.zeros((3, 4, LANE))
    vals[0, 0, 5] = 1.0
    vals[2, 0, 0] = 2.0                 # slot 1 of block 0 is empty
    vals[0, 2, 127] = -1.0
    vals[1, 3, 9] = 3.0
    assert tfmt.bell_counts(vals).tolist() == [3, 0, 1, 2]
    sv = np.zeros((2, 2 * LANE))
    sv[0, 0:7] = 1.0
    sv[0, LANE + 127] = 2.0
    sv[1, 3] = -1.0                     # lanes 0-2 hold explicit zeros
    assert tfmt.swellt_counts(sv).tolist() == [7, 128, 4, 0]
