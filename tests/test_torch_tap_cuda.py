"""The port's topology-aware (TAP) exchange on the card against the same
code on the CPU: the forward and transpose exchanges, ``tap_spmv`` and
``tap_spmv_T``, and one TAP V-cycle of a distributed-setup hierarchy.

Every test here is marked ``cuda`` and skips without a card. They import
no JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_tap_cuda.py -q

The exchange moves values without arithmetic, so it is exact; the SpMVs
and the cycle are held to 1e-12 of the largest value in float64 (the
kernels fuse multiply and add, and the scatter-adds sum in another order
on the card).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu_torch.comm import tap  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.device import par as dpar  # noqa: E402
from raptor_tpu_torch.device.tap_ops import tap_spmv, tap_spmv_T  # noqa
from raptor_tpu_torch.gallery import stencils  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _matrix(name):
    if name == "aniso":
        return stencils.par_stencil_grid(
            stencils.diffusion_stencil_2d(0.001, np.pi / 8), (96, 96), 8)
    m = (sp.random(3000, 3000, density=0.002, random_state=0, format="csr")
         + sp.identity(3000, format="csr")).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    csr = CSRMatrix.from_scipy(m)
    return ParCSRMatrix(csr, Partition.create(3000, 3000, 8))


def _close(got, ref, tol=1e-12):
    ref = ref.cpu()
    torch.testing.assert_close(got.cpu(), ref, rtol=0,
                               atol=tol * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("hl", [(2, 4), (4, 2)])
@pytest.mark.parametrize("name", ["aniso", "random"])
def test_tap_exchange_and_spmv_card_equals_cpu(cuda, hl, name):
    A = _matrix(name)
    plan = tap.build_tap_plan(A, *hl)
    part = A.partition
    rng = np.random.default_rng(0)
    xc = rng.standard_normal(A.global_num_cols)
    xr = rng.standard_normal(A.global_num_rows)
    out = {}
    for dev in (cuda, "cpu"):
        dA = dpar.device_put_matrix(A, need_transpose=True, device=dev)
        T = tap.device_put_tap(plan, torch.float64,
                               dpar.resolve_device(dev))
        x = dpar.device_put_vector(xc, part.col_bounds, dA.cols_pad,
                                   device=dev)
        y = dpar.device_put_vector(xr, part.row_bounds, dA.rows_pad,
                                   device=dev)
        halo = tap.tap_halo_exchange(T, x)
        out[str(dev)] = (halo, tap.tap_halo_exchange_T(T, halo, dA.cols_pad),
                         tap_spmv(dA, T, x), tap_spmv_T(dA, T, y),
                         dpar.spmv(dA, x))
    g, c = out[str(cuda)], out["cpu"]
    assert torch.equal(g[0].cpu(), c[0])
    for got, ref in zip(g[1:], c[1:]):
        _close(got, ref)
    # the TAP SpMV launches the same on-block kernel as the plain one
    _close(g[2], g[4])


@pytest.mark.cuda
def test_tap_vcycle_card_equals_cpu(cuda):
    A = stencils.par_stencil_grid(
        stencils.diffusion_stencil_2d(0.001, np.pi / 8), (64, 64), 8)
    ml = ParRugeStubenSolver(0.25, CoarsenType.HMIS, InterpType.Extended,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.setup_mode = "distributed"
    ml.setup(A)
    ml.tap_amg = 0
    b = A.mult(np.ones(A.global_num_rows))
    out = []
    for dev in (cuda, "cpu"):
        dh = DeviceHierarchy(ml, dtype=torch.float64, lane_pad=128,
                             device=dev, mesh=dpar.make_mesh2(2, 4))
        out.append(dh.host(dh.vcycle(dh.vector(np.zeros_like(b)),
                                     dh.vector(b))))
    np.testing.assert_allclose(out[0], out[1], rtol=0,
                               atol=1e-12 * np.abs(out[1]).max())
