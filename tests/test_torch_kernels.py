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


def _bdia_case(rng, S, P, A_pad, rows, C, dtype, device):
    d = tuple(sorted(rng.choice(np.arange(-6, 7), P).tolist()))
    padb = max(1, max(abs(v) for v in d))
    idx = torch.from_numpy(rng.integers(0, 128, (S, P, A_pad, 128),
                                        dtype=np.int8)).to(device)
    vals = torch.from_numpy(
        rng.standard_normal((S, P, A_pad, 128))).to(device, dtype)
    x = torch.from_numpy(rng.standard_normal((S, C))).to(device, dtype)
    offs = torch.tensor(d, dtype=torch.int32, device=device)
    return d, offs, idx, vals, x, padb, rows


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
    d, offs, idx, vals, x, padb, rows = _bdia_case(
        rng, 2, 4, 3, 300, 350, torch.float64, "cpu")
    assert torch.equal(
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows),
        formats.bdia_spmv(d, idx, vals, x, padb, rows))
    assert kernels.LAUNCHES == {"dia_spmv": 0, "bdia_spmv": 0}


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
@pytest.mark.parametrize("S,P,A_pad,rows,C", [(1, 40, 256, 32700, 33000),
                                              (3, 7, 8, 1000, 900),
                                              (2, 1, 1, 100, 77)])
def test_bdia_kernel_matches_plain(cuda, dtype, S, P, A_pad, rows, C):
    rng = np.random.default_rng(S * 1000 + P)
    d, offs, idx, vals, x, padb, rows = _bdia_case(rng, S, P, A_pad, rows,
                                                   C, dtype, cuda)
    before = kernels.LAUNCHES["bdia_spmv"]
    got = kernels.bdia_spmv(d, offs, idx, vals, x, padb, rows)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bdia_spmv"] == before + 1
    ref = formats.bdia_spmv(d, idx, vals, x, padb, rows)
    assert got.shape == ref.shape == (S, rows)
    assert _close(got, ref, dtype)


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
    d, offs, idx, vals, x, padb, rows = _bdia_case(
        rng, 1, 3, 2, 256, 256, torch.float32, cuda)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx.int(), vals, x, padb, rows)
    with pytest.raises(ValueError):
        kernels.bdia_spmv(d, offs, idx, vals, x, padb, 257)
