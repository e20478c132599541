"""The port's CUDA SpMV kernels against their plain PyTorch versions.

The tests marked ``cuda`` need an NVIDIA card and ``nvcc``; they skip
elsewhere. On a machine with the card they run without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

The others run on the CPU, where the wrappers take the plain versions.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.device import formats, kernels  # noqa: E402

# max |kernel - plain| / max |plain|: the kernel fuses multiply and add and
# so rounds differently from the plain version's separate steps
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dia_case(rng, S, K, R, C, dtype, device):
    offsets = tuple(sorted(rng.choice(np.arange(-300, 301), K,
                                      replace=False).tolist()))
    pad = max(1, max(abs(o) for o in offsets))
    vals = torch.from_numpy(rng.standard_normal((S, K, R))).to(device, dtype)
    x = torch.from_numpy(rng.standard_normal((S, C))).to(device, dtype)
    offs = torch.tensor(offsets, dtype=torch.int32, device=device)
    return offsets, offs, vals, x, pad


def _bdia_case(rng, S, P, A_pad, rows, C, dtype, device, keep=1.0,
               empty_blocks=(), empty_shards=()):
    """Random BDIA planes in which a share ``keep`` of the (plane, row
    block) tiles hold values, the row blocks ``empty_blocks`` and the
    shards ``empty_shards`` none; the tile list of what is left
    (``formats.bdia_tiles``). Zeroed tiles keep random lane ids."""
    d = tuple(sorted(rng.choice(np.arange(-6, 7), P).tolist()))
    padb = max(1, max(abs(v) for v in d))
    idx = rng.integers(0, 128, (S, P, A_pad, 128), dtype=np.int8)
    vals = rng.standard_normal((S, P, A_pad, 128))
    vals[rng.random((S, P, A_pad)) >= keep] = 0.0
    vals[:, :, list(empty_blocks)] = 0.0
    vals[list(empty_shards)] = 0.0
    tptr, tplane = formats.bdia_tiles(vals, rows)
    x = torch.from_numpy(rng.standard_normal((S, C))).to(device, dtype)
    offs = torch.tensor(d, dtype=torch.int32, device=device)
    return (d, offs, torch.from_numpy(idx).to(device),
            torch.from_numpy(vals).to(device, dtype), x, padb, rows,
            torch.from_numpy(tptr).to(device),
            torch.from_numpy(tplane).to(device))


def _well_case(rng, S, W, T, ba, rows, C, dtype, device):
    """Random windowed-ELL layout with window starts up to the packer's
    clamp, so windows reach past the end of x into the padded source
    height (zeros in the plain version, the kernel's bounds check)."""
    R = T * ba * 128
    WR = 8
    cap = formats.wind_src_height(C, WR) - WR
    ws = rng.integers(0, cap + 1, (S, T)).astype(np.int32) & ~7
    rel = rng.integers(0, WR * 128, (S, W, R)).astype(np.int32)
    vals = rng.standard_normal((S, W, R))
    vals[rng.random((S, W, R)) < 0.2] = 0.0            # padding slots
    x = rng.standard_normal((S, C))
    return (torch.from_numpy(ws).to(device), torch.from_numpy(rel).to(device),
            torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(x).to(device, dtype), ba, WR, rows)


def _swellt_case(rng, S, T, Kp, n_out, C, dtype, device, ragged=False,
                 local=False):
    """Random sorted-scatter layout with zero-valued padding entries and
    slot windows that reach past n_out (those targets are dropped); the
    slot counts (``formats.swellt_counts``) last. ``ragged``: each slot
    holds a random number of real entries from lane 0, the rest padding
    (value 0, meta 0), as the packer fills it: tile 0 full, tile 1 unused
    (count 0) and, when S > 1, the last shard all padding. ``local``: the
    window bases follow the tile, multiples of SWELLT_AMAX as packed, so
    most targets of a CTA fall in its shared-memory accumulator; else they
    scatter over the output, and most go to global atomics."""
    KL = Kp * 128
    h = -(-n_out // 128)
    srcl = rng.integers(0, 128, (S, T, KL))
    qrel = rng.integers(0, 32, (S, T, KL))
    lout = rng.integers(0, 128, (S, T, KL))
    meta = (srcl | qrel << 7 | lout << 12).astype(np.int32)
    vals = rng.standard_normal((S, T, KL))
    if ragged:
        n = rng.integers(0, 129, (S, T, Kp))
        n[:, 0] = 128
        if T > 1:
            n[:, 1] = 0
        if S > 1:
            n[-1] = 0
        pad = (np.arange(128) >= n[..., None]).reshape(S, T, KL)
    else:
        pad = rng.random((S, T, KL)) < 0.3
    vals[pad], meta[pad] = 0.0, 0
    if local:
        t = np.repeat(np.arange(T), Kp)
        qb = (t * h // T + rng.integers(0, 48, (S, T * Kp))).clip(0, h)
        qb = (qb & ~(formats.SWELLT_AMAX - 1)).astype(np.int32)
    else:
        qb = (rng.integers(0, h + 1, (S, T * Kp)) & ~7).astype(np.int32)
    x = rng.standard_normal((S, C))
    cnt = np.stack([formats.swellt_counts(v) for v in vals])
    return (torch.from_numpy(meta).to(device),
            torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(qb).to(device),
            torch.from_numpy(x).to(device, dtype), n_out,
            torch.from_numpy(cnt).to(device))


def _bell_case(rng, S, W, A128, rows, C, dtype, device, ragged=False):
    """Random BELL layout; the last source block of x is ragged when C is
    not a multiple of 128; the slot counts (``formats.bell_counts``) last.
    ``ragged``: each row block holds a random number of real slots, the
    rest padding (value 0), as ``bell_arrays`` packs a skewed operator:
    block 0 all W, block 1 none and, when S > 1, the last shard none; a
    fifth of the rows of a real slot are empty."""
    src = rng.integers(0, -(-C // 128), (S, W, A128)).astype(np.int32)
    idx = rng.integers(0, 128, (S, W, A128, 128), dtype=np.int8)
    vals = rng.standard_normal((S, W, A128, 128))
    if ragged:
        n = rng.integers(0, W + 1, (S, A128))
        n[:, 0] = W
        if A128 > 1:
            n[:, 1] = 0
        if S > 1:
            n[-1] = 0
        vals[np.arange(W)[None, :, None] >= n[:, None, :]] = 0.0
        vals[rng.random(vals.shape) < 0.2] = 0.0
    x = rng.standard_normal((S, C))
    cnt = np.stack([formats.bell_counts(v) for v in vals])
    return (torch.from_numpy(src).to(device), torch.from_numpy(idx).to(device),
            torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(x).to(device, dtype), rows,
            torch.from_numpy(cnt).to(device))


def _close(got, ref, dtype):
    """max |got - ref| <= TOL * max |ref| (exact when ref is all zeros)."""
    return float((got - ref).abs().max()) <= TOL[dtype] * float(
        ref.abs().max())


def test_wrappers_take_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    kernels.reset_launches()
    offsets, offs, vals, x, pad = _dia_case(rng, 2, 5, 300, 280,
                                            torch.float64, "cpu")
    assert torch.equal(kernels.dia_spmv(offsets, offs, vals, x, pad),
                       formats.dia_spmv(offsets, vals, x, pad))
    d, offs, idx, vals, x, padb, rows, tptr, tplane = _bdia_case(
        rng, 2, 4, 3, 300, 350, torch.float64, "cpu", keep=0.5)
    assert torch.equal(
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows, tptr, tplane),
        formats.bdia_spmv(d, idx, vals, x, padb, rows))
    args = _well_case(rng, 2, 3, 2, 8, 2000, 900, torch.float64, "cpu")
    assert torch.equal(kernels.wind_ell_spmv(*args),
                       formats.wind_ell_spmv(*args))
    args = _swellt_case(rng, 2, 3, 2, 500, 350, torch.float64, "cpu")
    assert torch.equal(kernels.swellt_spmv_T(*args),
                       formats.swellt_spmv_T(*args[:5]))
    args = _bell_case(rng, 2, 4, 3, 300, 350, torch.float64, "cpu")
    assert torch.equal(kernels.bell_spmv(*args),
                       formats.bell_spmv(*args[:5]))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.SOURCES, 0)


def test_wrappers_refuse_cpu_x_with_other_operands():
    """Only all-CPU arguments take the plain version: a CPU x beside an
    operand on another device is refused before anything runs."""
    rng = np.random.default_rng(4)
    away = "meta"   # a device other than the CPU, present on every build
    offsets, offs, vals, x, pad = _dia_case(rng, 1, 3, 40, 40,
                                            torch.float64, "cpu")
    cases = [(kernels.dia_spmv, (offsets, offs, vals.to(away), x, pad))]
    d, offs, idx, vals, x, padb, rows, tptr, tplane = _bdia_case(
        rng, 1, 2, 1, 100, 100, torch.float64, "cpu")
    cases.append((kernels.bdia_spmv,
                   (d, offs, idx.to(away), vals, x, padb, rows, tptr,
                    tplane)))
    cases.append((kernels.bdia_spmv,
                   (d, offs, idx, vals, x, padb, rows, tptr,
                    tplane.to(away))))
    ws, rel, vals, x, ba, WR, rows = _well_case(rng, 1, 2, 1, 8, 900, 300,
                                                torch.float64, "cpu")
    cases.append((kernels.wind_ell_spmv,
                  (ws.to(away), rel, vals, x, ba, WR, rows)))
    meta, vals, qb, x, n_out, cnt = _swellt_case(rng, 1, 2, 1, 200, 200,
                                                 torch.float64, "cpu")
    cases.append((kernels.swellt_spmv_T, (meta, vals, qb.to(away), x,
                                          n_out, cnt)))
    cases.append((kernels.swellt_spmv_T, (meta, vals, qb, x, n_out,
                                          cnt.to(away))))
    src, idx, vals, x, rows, cnt = _bell_case(rng, 1, 2, 2, 200, 200,
                                              torch.float64, "cpu")
    cases.append((kernels.bell_spmv, (src, idx, vals.to(away), x, rows,
                                      cnt)))
    cases.append((kernels.bell_spmv, (src, idx, vals, x, rows,
                                      cnt.to(away))))
    kernels.reset_launches()
    for fn, args in cases:
        with pytest.raises(ValueError, match="x lies on cpu"):
            fn(*args)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.SOURCES, 0)


def test_plain_dia_matches_dense_product():
    """The plain DIA version against a dense matrix built from the same
    diagonals (the definition the kernel implements)."""
    rng = np.random.default_rng(1)
    offsets, _, vals, x, pad = _dia_case(rng, 1, 4, 50, 40, torch.float64,
                                         "cpu")
    dense = np.zeros((50, 40))
    for k, off in enumerate(offsets):
        for i in range(50):
            if 0 <= i + off < 40:
                dense[i, i + off] = vals[0, k, i]
    want = dense @ x[0].numpy()
    got = formats.dia_spmv(offsets, vals, x, pad)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_kernel_module_imports_without_nvcc():
    """Importing the kernel module neither builds nor needs nvcc."""
    code = ("import os; os.environ['PATH'] = '';"
            "os.environ.pop('CUDA_HOME', None);"
            "import raptor_tpu_torch.device.kernels as k;"
            "assert not k._libs")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,K,R,C", [(1, 9, 70000, 70000),
                                     (3, 64, 5000, 4100),
                                     (2, 1, 129, 300)])
def test_dia_kernel_matches_plain(cuda, dtype, S, K, R, C):
    rng = np.random.default_rng(S * 1000 + K)
    offsets, offs, vals, x, pad = _dia_case(rng, S, K, R, C, dtype, cuda)
    before = kernels.LAUNCHES["dia_spmv"]
    got = kernels.dia_spmv(offsets, offs, vals, x, pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["dia_spmv"] == before + 1
    ref = formats.dia_spmv(offsets, vals, x, pad)
    assert got.shape == ref.shape == (S, R)
    assert _close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "S,P,A_pad,rows,C,keep,empty_blocks,empty_shards",
    [(1, 40, 256, 32700, 33000, 1.0, (), ()),
     (3, 7, 8, 1000, 900, 1.0, (), ()),
     (2, 1, 1, 100, 77, 1.0, (), ()),
     # most tiles empty, as on the embedded transfer operators
     (1, 300, 320, 40000, 41000, 0.1, (), ()),
     # a row block with no tile, in the middle and at the end
     (2, 9, 16, 2000, 2100, 0.5, (3, 15), ()),
     # a shard with no tile at all
     (3, 6, 8, 1024, 1000, 0.7, (), (1,)),
     # rows_pad not a multiple of 128 and below A_pad * 128
     (2, 5, 12, 1337, 1500, 0.3, (), ())])
def test_bdia_kernel_matches_plain(cuda, dtype, S, P, A_pad, rows, C, keep,
                                   empty_blocks, empty_shards):
    """The kernel sums the listed tiles only; the plain version every
    plane. A tile left out holds zeros, so both give the same product."""
    rng = np.random.default_rng(S * 1000 + P)
    d, offs, idx, vals, x, padb, rows, tptr, tplane = _bdia_case(
        rng, S, P, A_pad, rows, C, dtype, cuda, keep, empty_blocks,
        empty_shards)
    before = kernels.LAUNCHES["bdia_spmv"]
    got = kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows, tptr, tplane)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bdia_spmv"] == before + 1
    ref = formats.bdia_spmv(d, idx, vals, x, padb, rows)
    assert got.shape == ref.shape == (S, rows)
    assert _close(got, ref, dtype)
    for s in empty_shards:
        assert not got[s].any()


def _launch_once(name, fn, args):
    before = kernels.LAUNCHES[name]
    got = fn(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,W,T,rows,C", [(1, 11, 64, 65000, 8000),
                                          (3, 83, 5, 4500, 70000),
                                          (2, 1, 1, 1, 5)])
def test_wind_ell_kernel_matches_plain(cuda, dtype, S, W, T, rows, C):
    """Ragged row tails (rows < T*1024), several shards, padding slots and
    an x shorter than the padded source height."""
    rng = np.random.default_rng(S * 1000 + W)
    args = _well_case(rng, S, W, T, 8, rows, C, dtype, cuda)
    got = _launch_once("wind_ell_spmv", kernels.wind_ell_spmv, args)
    ref = formats.wind_ell_spmv(*args)
    assert got.shape == ref.shape == (S, rows)
    assert _close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,T,Kp,n_out,C,ragged,local",
                         [(1, 2000, 8, 170000, 256000, False, False),
                          (3, 7, 3, 900, 800, False, False),
                          (2, 1, 1, 1, 1, False, False),
                          # suffix padding, unused slots, an empty shard
                          (3, 40, 5, 20000, 5000, True, False),
                          # the packed shape: most targets in shared memory
                          (1, 16384, 7, 170752, 2097152, True, True),
                          # a ragged last group of tiles, 2 shards
                          (2, 37, 9, 9000, 4700, True, True),
                          # wide tiles: fewer tiles a CTA, then one tile
                          # whose slot tables alone pass 48 KB
                          (1, 9, 300, 40000, 1200, True, True),
                          (1, 2, 6500, 90000, 256, True, True)])
def test_swellt_kernel_matches_plain(cuda, dtype, S, T, Kp, n_out, C,
                                     ragged, local):
    """Atomic adds: the float32 sum order varies between runs, which the
    relative tolerance of max |ref| covers; padding entries (val 0) and
    targets past n_out drop out."""
    rng = np.random.default_rng(S * 1000 + Kp)
    args = _swellt_case(rng, S, T, Kp, n_out, C, dtype, cuda, ragged, local)
    got = _launch_once("swellt_spmv_T", kernels.swellt_spmv_T, args)
    ref = formats.swellt_spmv_T(*args[:5])
    assert got.shape == ref.shape == (S, n_out)
    assert _close(got, ref, dtype)
    if ragged and S > 1:
        assert not got[-1].any()


@pytest.mark.cuda
def test_swellt_launch_shape(cuda):
    """The sorted-scatter kernel's launch shape, as its library reports it
    for the host model: at least one tile a CTA, its slot tables within
    4,096 slots unless one tile holds more, the group no wider as Kp
    grows, and a window of whole SWELLT_AMAX windows."""
    last = None
    for Kp in (1, 7, 100, 300, 4096, 6500):
        group, span = kernels.swellt_launch_shape(Kp)
        assert group >= 1 and (group * Kp <= 4096 or group == 1)
        assert last is None or group <= last
        assert span > 0 and span % formats.SWELLT_AMAX == 0
        last = group


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S,W,A128,rows,C,ragged",
                         [(1, 24, 2048, 262000, 40000, False),
                          (3, 5, 9, 1100, 700, False),
                          (2, 1, 1, 100, 77, False),
                          # counts from 0 to W, one full and one empty block
                          # per shard, an empty last shard; 4 and 8 warps
                          (3, 23, 64, 8100, 9000, True),
                          (2, 100, 40, 5000, 7000, True),
                          # hundreds of slots (16 warps) and more than one
                          # chunk of source ids
                          (1, 200, 6, 768, 20000, True),
                          (1, 447, 6, 768, 20000, True),
                          (2, 1500, 3, 300, 50000, True)])
def test_bell_kernel_matches_plain(cuda, dtype, S, W, A128, rows, C, ragged):
    rng = np.random.default_rng(S * 1000 + W)
    args = _bell_case(rng, S, W, A128, rows, C, dtype, cuda, ragged)
    got = _launch_once("bell_spmv", kernels.bell_spmv, args)
    ref = formats.bell_spmv(*args[:5])
    assert got.shape == ref.shape == (S, rows)
    assert _close(got, ref, dtype)
    if ragged and S > 1:
        assert not got[-1].any()


@pytest.mark.cuda
def test_kernels_refuse_bad_inputs(cuda):
    rng = np.random.default_rng(3)
    offsets, offs, vals, x, pad = _dia_case(rng, 2, 5, 300, 300,
                                            torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.dia_spmv(offsets, offs, vals, x.double(), pad)
    with pytest.raises(ValueError):
        kernels.dia_spmv(offsets, offs, vals, x.t().contiguous().t(), pad)
    with pytest.raises(TypeError):
        kernels.dia_spmv(offsets, offs, vals.half(), x.half(), pad)
    # a CPU x with operands on the card: refused, not sent to the plain
    # version (which would fail inside torch)
    with pytest.raises(ValueError):
        kernels.dia_spmv(offsets, offs, vals, x.cpu(), pad)
    d, offs, idx, vals, x, padb, rows, tptr, tplane = _bdia_case(
        rng, 1, 3, 2, 256, 256, torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx.int(), vals, x, padb, rows, tptr,
                          tplane)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, 257, tptr, tplane)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows, tptr.long(),
                          tplane)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows,
                          tptr[:, 1:].contiguous(), tplane)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows, tptr,
                          tplane[:, :0])
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows, tptr,
                          tplane.cpu())
    ws, rel, vals, x, ba, WR, rows = _well_case(
        rng, 1, 2, 2, 8, 2048, 500, torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.wind_ell_spmv(ws, rel.long(), vals, x, ba, WR, rows)
    with pytest.raises(ValueError):
        kernels.wind_ell_spmv(ws, rel, vals, x, 4, WR, rows)   # ws shape
    with pytest.raises(ValueError):
        kernels.wind_ell_spmv(ws, rel, vals, x, ba, WR, 2049)
    with pytest.raises(ValueError):
        kernels.wind_ell_spmv(ws, rel, vals, x.cpu(), ba, WR, rows)
    meta, vals, qb, x, n_out, cnt = _swellt_case(rng, 1, 3, 2, 300, 300,
                                                 torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta, vals, qb[:, 1:], x, n_out, cnt)
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta, vals.double(), qb, x, n_out, cnt)
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta.long(), vals, qb, x, n_out, cnt)
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta, vals, qb, x.cpu(), n_out, cnt)
    with pytest.raises(ValueError):        # the counts: shape, dtype, device
        kernels.swellt_spmv_T(meta, vals, qb, x, n_out,
                              cnt[:, 1:].contiguous())
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta, vals, qb, x, n_out, cnt.long())
    with pytest.raises(ValueError):
        kernels.swellt_spmv_T(meta, vals, qb, x, n_out, cnt.cpu())
    src, idx, vals, x, rows, cnt = _bell_case(rng, 1, 3, 2, 256, 256,
                                              torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.bell_spmv(src.long(), idx, vals, x, rows, cnt)
    with pytest.raises(ValueError):
        kernels.bell_spmv(src, idx.int(), vals, x, rows, cnt)
    with pytest.raises(ValueError):
        kernels.bell_spmv(src, idx, vals[:, :, :, :64].contiguous(), x,
                          rows, cnt)
    with pytest.raises(ValueError):
        kernels.bell_spmv(src, idx, vals, x.cpu(), rows, cnt)
    with pytest.raises(ValueError):        # the counts: shape, dtype, device
        kernels.bell_spmv(src, idx, vals, x, rows, cnt[:, :1].contiguous())
    with pytest.raises(ValueError):
        kernels.bell_spmv(src, idx, vals, x, rows, cnt.short())
    with pytest.raises(ValueError):
        kernels.bell_spmv(src, idx, vals, x, rows, cnt.cpu())
