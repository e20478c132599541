"""The port's device setup engines on the card against the same engines on
the CPU: the Galerkin product (``device.spgemm``) and the extended+i and
modified-classical interpolations (``device.interp``).

Every test here is marked ``cuda`` and skips without a card. They import
no JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_engines_cuda.py -q

The structure must be equal and the values within 1e-12 of the largest in
float64 (1e-5 in float32): the engines sort and scan in the same fixed
order on both devices, and only the reductions of the interpolation may
add in another order.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu_torch.core.matrix import CSRMatrix  # noqa: E402
from raptor_tpu_torch.core.types import StrengthType  # noqa: E402
from raptor_tpu_torch.device import interp as dinterp  # noqa: E402
from raptor_tpu_torch.device import spgemm as dsp  # noqa: E402
from raptor_tpu_torch.gallery import stencils  # noqa: E402
from raptor_tpu_torch.ruge_stuben import cf_splitting as cf  # noqa: E402
from raptor_tpu_torch.ruge_stuben import interpolation as itp  # noqa: E402
from raptor_tpu_torch.ruge_stuben.strength import strength  # noqa: E402
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

TOL = {np.float64: 1e-12, np.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(got, ref, tol):
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    scale = max(1.0, float(np.abs(ref.data).max()) if ref.nnz else 1.0)
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=tol * scale)


def _random(n_rows, n_cols, per_row, seed):
    m = sp.random(n_rows, n_cols, density=per_row / n_cols,
                  random_state=seed, format="csr")
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def _grid(kind, n):
    if kind == "aniso":
        st = stencils.diffusion_stencil_2d(0.001, np.pi / 8)
        return stencils.par_stencil_grid(st, (n, n), 1)
    return stencils.par_stencil_grid(stencils.laplace_stencil_27pt(),
                                     (n, n, n), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("left", ["stencil", "random"])
def test_spgemm_card_equals_cpu(cuda, left, dtype):
    a = (_grid("aniso", 200).global_csr if left == "stencil"
         else _random(20000, 20000, 9, 1))
    b = _random(a.n_cols, a.n_cols // 4, 4, 2)
    got = dsp.spgemm_device(a, b, dtype=dtype, device=cuda)
    _same(got, dsp.spgemm_device(a, b, dtype=dtype, device="cpu"),
          TOL[dtype])


@pytest.fixture(scope="module")
def lap_a_p():
    """Level 0's A and P of a 32^3 PMIS + extended+i setup (host
    engines)."""
    from raptor_tpu_torch.core.types import CoarsenType, InterpType
    from raptor_tpu_torch.multilevel.par_multilevel import (
        ParRugeStubenSolver)
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended)
    ml.rap_mode = ml.interp_mode = "host"
    ml.max_levels = 2
    ml.setup(_grid("lap", 32))
    return ml.levels[0].A.global_csr, ml.levels[0].P.global_csr


@pytest.mark.cuda
@pytest.mark.parametrize("need_ap", [True, False])
def test_rap_card_equals_cpu_and_repeats_bytes(cuda, lap_a_p, need_ap):
    a, p = lap_a_p
    ap, ac, nnz = dsp.rap_device(a, p, need_ap=need_ap, device=cuda)
    cap, cac, cnnz = dsp.rap_device(a, p, need_ap=need_ap, device="cpu")
    assert nnz == cnnz
    _same(ac, cac, 1e-12)
    if need_ap:
        _same(ap, cap, 1e-12)
    _, again, _ = dsp.rap_device(a, p, need_ap=need_ap, device=cuda)
    np.testing.assert_array_equal(again.indices, ac.indices)
    assert again.data.tobytes() == ac.data.tobytes()


def _interp_inputs(kind, n, split):
    A = _grid(kind, n)
    s = strength(A, StrengthType.Classical, 0.25)
    states = split(s, form_rand_weights(A.global_num_rows, 0))
    strong, col_to_new, n_coarse = itp._device_interp_inputs(
        A.global_csr, s.global_csr, states)
    return A.global_csr, states, strong, col_to_new, n_coarse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind,n,split", [("lap", 32, cf.split_pmis),
                                          ("aniso", 128, cf.split_hmis)])
def test_extended_card_equals_cpu(cuda, kind, n, split, dtype):
    a, states, strong, col_to_new, n_coarse = _interp_inputs(kind, n, split)
    got = dinterp.extended_interp_device(a, strong, states, col_to_new,
                                         n_coarse, dtype=dtype, device=cuda)
    _same(got, dinterp.extended_interp_device(
        a, strong, states, col_to_new, n_coarse, dtype=dtype, device="cpu"),
        TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind,n,split", [("aniso", 128, cf.split_cljp),
                                          ("lap", 32, cf.split_pmis)])
def test_mod_classical_card_equals_cpu(cuda, kind, n, split, dtype):
    a, states, strong, col_to_new, n_coarse = _interp_inputs(kind, n, split)
    got = dinterp.mod_classical_interp_device(
        a, strong, states, col_to_new, n_coarse, dtype=dtype, device=cuda)
    _same(got, dinterp.mod_classical_interp_device(
        a, strong, states, col_to_new, n_coarse, dtype=dtype, device="cpu"),
        TOL[dtype])
