"""The tile list of the BDIA kernel (``formats.bdia_tiles``, packed by
``par.device_put_matrix`` as ``bd_tptr`` / ``bd_tplane``) on the BDIA
operators of the 2-D flagship at 256 x 256 and the 3-D 27-point Laplacian
at 16^3, packed in float64 with lane padding 128 as the device hierarchy
packs them.

The list is the kernel's precondition: every nonzero of the packed planes
lies in a listed tile, and the sum over the listed tiles is the sum over
every plane. Both are held here, on the CPU, by a PyTorch emulation of the
kernel's tiled sum against the plain ``formats.bdia_spmv``. The planes
stay byte-equal to the JAX package's, and the list is the same for the
float32 and the float64 pack.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu_torch.device import formats as tfmt  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402

from _torch_parity import jax_hierarchy, jax_hierarchy3d, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

LANE = 128
# (problem, shards, level, operator): every BDIA operator of the two
# hierarchies at one shard, and the 3-D transfer operators at four
OPERATORS = [("2d", 1, 2, "P"), ("2d", 1, 2, "Pt"), ("2d", 1, 3, "A"),
             ("2d", 1, 3, "P"), ("2d", 1, 3, "Pt"), ("2d", 1, 5, "A"),
             ("3d", 1, 0, "P"), ("3d", 1, 0, "Pt"), ("3d", 1, 1, "A"),
             ("3d", 1, 1, "Pt"), ("3d", 4, 0, "P"), ("3d", 4, 0, "Pt")]
EMBED = {"A": None, "P": "cols", "Pt": "rows"}


def _host_matrix(problem, S, level, op):
    ml = jax_hierarchy(256, S) if problem == "2d" else jax_hierarchy3d(16, S)
    lvl = ml.levels[level]
    return {"A": lvl.A, "P": lvl.P, "Pt": lvl.P.transpose()}[op]


def _packed(problem, S, level, op, dtype=torch.float64):
    tA = tpar.device_put_matrix(to_port(_host_matrix(problem, S, level, op)),
                                dtype=dtype, lane_pad=128, embed=EMBED[op],
                                need_transpose=False, device="cpu")
    assert tA.on_format == "bdia"
    return tA


def _occupied(tA):
    """[S, P, nblk] True where the tile vals[s, p, a, :] has a nonzero."""
    nblk = -(-tA.on_rows_pad // LANE)
    return (tA.bd_vals[:, :, :nblk] != 0).any(dim=3)


def _listed(tA):
    """[S, P, nblk] True where the list holds the tile."""
    S, P = tA.bd_vals.shape[:2]
    tptr, tplane = tA.bd_tptr, tA.bd_tplane
    nblk = tptr.shape[1] - 1
    out = torch.zeros((S, P, nblk), dtype=torch.bool)
    for s in range(S):
        blk = torch.repeat_interleave(torch.arange(nblk), tptr[s].diff())
        out[s, tplane[s, :int(tptr[s, -1])].long(), blk] = True
    return out


def _tiled_spmv(tA, x):
    """What the kernel computes: for each listed tile (s, p, a), out[s,
    a*128 + l] += vals[s,p,a,l] * x[s, (a + d_p)*128 + idx[s,p,a,l]], x zero
    outside [0, C); the unlisted tiles are never read."""
    S, C = x.shape
    tptr, tplane = tA.bd_tptr, tA.bd_tplane
    nblk = tptr.shape[1] - 1
    d = torch.tensor(tA.bd_offsets, dtype=torch.long)
    out = torch.zeros((S, nblk, LANE), dtype=x.dtype)
    for s in range(S):
        blk = torch.repeat_interleave(torch.arange(nblk), tptr[s].diff())
        p = tplane[s, :int(tptr[s, -1])].long()
        j = (blk + d[p])[:, None] * LANE + tA.bd_idx[s, p, blk].long()
        ok = (j >= 0) & (j < C)
        xv = torch.where(ok, x[s, j.clamp(0, C - 1)], 0.0)
        out[s].index_add_(0, blk, tA.bd_vals[s, p, blk] * xv)
    return out.reshape(S, -1)[:, :tA.on_rows_pad]


@pytest.mark.parametrize("problem,S,level,op", OPERATORS)
def test_tiles_are_the_nonempty_tiles(problem, S, level, op):
    """Every nonzero lies in a listed tile, every listed tile holds one,
    and each row block's planes are listed once, in increasing order."""
    tA = _packed(problem, S, level, op)
    nblk = -(-tA.on_rows_pad // LANE)
    assert tA.bd_tptr.dtype == tA.bd_tplane.dtype == torch.int32
    assert tA.bd_tptr.shape == (S, nblk + 1)
    assert torch.equal(_listed(tA), _occupied(tA))
    # the packer leaves the rows past the kernel's row blocks empty
    assert not tA.bd_vals[:, :, nblk:].any()
    for s in range(S):
        ptr = tA.bd_tptr[s]
        assert int(ptr[0]) == 0
        assert bool((ptr.diff() >= 0).all())
        assert int(ptr[-1]) == int(_occupied(tA)[s].sum())
        for a in range(nblk):
            planes = tA.bd_tplane[s, int(ptr[a]):int(ptr[a + 1])]
            assert bool((planes.diff() > 0).all())
        assert not tA.bd_tplane[s, int(ptr[-1]):].any()
    assert tA.bd_tplane.shape[1] == max(1, int(tA.bd_tptr[:, -1].max()))


@pytest.mark.parametrize("problem,S,level,op", OPERATORS)
def test_tiled_sum_equals_plain(problem, S, level, op):
    """The sum over the listed tiles equals ``formats.bdia_spmv``'s sum over
    every plane, to 1e-12 relative (the order of the sum differs)."""
    tA = _packed(problem, S, level, op)
    C = tA.rows_pad if tA.embed_kind == "cols" else tA.cols_pad
    x = torch.from_numpy(np.random.default_rng(level).standard_normal(
        (S, C)))
    want = tfmt.bdia_spmv(tA.bd_offsets, tA.bd_idx, tA.bd_vals, x,
                          tA.bd_padb, tA.on_rows_pad)
    got = _tiled_spmv(tA, x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("problem,S,level,op", OPERATORS)
def test_planes_equal_jax_and_list_equal_across_types(monkeypatch, problem,
                                                      S, level, op):
    """The list leaves the packed planes as they were (byte-equal to the
    JAX package's), and the float32 pack lists the same tiles."""
    monkeypatch.setenv("RAPTOR_TPU_WELL", "0")
    m = _host_matrix(problem, S, level, op)
    jA = jpar.device_put_matrix(m, jpar.make_mesh(S), dtype=jnp.float64,
                                lane_pad=128, embed=EMBED[op],
                                need_transpose=False)
    tA = _packed(problem, S, level, op)
    for f in ("bd_idx", "bd_vals"):
        assert getattr(tA, f).numpy().tobytes() == \
            np.asarray(getattr(jA, f)).tobytes(), f
    t32 = _packed(problem, S, level, op, torch.float32)
    assert torch.equal(t32.bd_tptr, tA.bd_tptr)
    assert torch.equal(t32.bd_tplane, tA.bd_tplane)


def test_other_formats_carry_an_empty_list():
    """A DIA operator carries the list's empty [S, 1] and [S, 0]."""
    tA = tpar.device_put_matrix(to_port(_host_matrix("2d", 1, 0, "A")),
                                lane_pad=128, device="cpu")
    assert tA.on_format == "dia"
    assert tA.bd_tptr.shape == (1, 1) and tA.bd_tplane.shape == (1, 0)


def test_bdia_tiles_on_synthetic_planes():
    """Ragged row count, an empty row block and an empty shard: the list
    skips them, and pads the shorter shard's planes with zeros."""
    vals = np.zeros((2, 3, 4, LANE))
    vals[0, 2, 0, 5] = 1.0
    vals[0, 0, 0, 127] = -2.0
    vals[0, 1, 2, 0] = 3.0
    vals[0, 1, 3, 9] = 4.0          # past rows_pad's row blocks: left out
    tptr, tplane = tfmt.bdia_tiles(vals, 2 * LANE + 7)
    assert tptr.tolist() == [[0, 2, 2, 3], [0, 0, 0, 0]]
    assert tplane.tolist() == [[0, 2, 1], [0, 0, 0]]
    tptr, tplane = tfmt.bdia_tiles(np.zeros((1, 2, 1, LANE)), LANE)
    assert tptr.tolist() == [[0, 0]] and tplane.tolist() == [[0]]
