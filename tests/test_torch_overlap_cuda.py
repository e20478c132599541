"""``device.par.spmv_overlap``, the SpMV with the halo exchange on a side
stream against the on-block product: bit-equal to ``spmv`` on the CPU and,
over a chain of 1,000 products, on the card; it refuses the exchange
across controllers and the topology-aware one.

The card's test is marked ``cuda`` and skips without a card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_overlap_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.device import par as dpar  # noqa: E402
from raptor_tpu_torch.gallery.stencils import (  # noqa: E402
    diffusion_stencil_2d, laplace_stencil_27pt, par_stencil_grid)


def _packed(stencil, shape, device, lane_pad=128):
    A = par_stencil_grid(stencil, shape, 8)
    dA = dpar.device_put_matrix(A, dtype=torch.float32, lane_pad=lane_pad,
                                device=device)
    x = dpar.device_put_vector(
        np.random.default_rng(0).random(A.global_num_cols),
        A.partition.col_bounds, dA.cols_pad, dtype=torch.float32,
        device=device)
    return dA, x


@pytest.mark.parametrize("stencil,shape", [
    (laplace_stencil_27pt(), (12, 12, 12)),
    (diffusion_stencil_2d(0.001, np.pi / 8), (40, 40))])
def test_overlap_equals_spmv_on_cpu(stencil, shape):
    """On CPU tensors it is spmv's order: the same bits, over 8 shards."""
    dA, x = _packed(stencil, shape, "cpu", lane_pad=1)
    assert torch.equal(dpar.spmv_overlap(dA, x), dpar.spmv(dA, x))


def test_overlap_refuses_controllers_and_tap():
    """The exchange across controllers (``A.comm``) and a TAP plan are not
    overlapped: both raise rather than run serialized."""
    dA, x = _packed(laplace_stencil_27pt(), (8, 8, 8), "cpu", lane_pad=1)
    with pytest.raises(NotImplementedError, match="controllers"):
        dpar.spmv_overlap(dataclasses.replace(dA, comm=object()), x)
    with pytest.raises(NotImplementedError, match="topology-aware"):
        dpar.spmv_overlap(dA, x, T=object())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_overlap_chain_bit_equal_on_card(cuda):
    """1,000 chained products x <- A x / max |A x| at 32^3 over 8 stacked
    shards, enqueued without a synchronize: every step's product through
    the side stream bit-equal to spmv's, and the side stream made once."""
    dA, x0 = _packed(laplace_stencil_27pt(), (32, 32, 32), cuda)

    def run(op):
        x, sums = x0, []
        for _ in range(1000):
            b = op(dA, x)
            sums.append(b.sum())
            x = b / b.abs().max()
        return x, torch.stack(sums)

    x_over, s_over = run(dpar.spmv_overlap)
    x_plain, s_plain = run(dpar.spmv)
    assert list(dpar._SIDE_STREAMS) == [x0.device]
    assert torch.equal(s_over, s_plain)
    assert torch.equal(x_over, x_plain)
