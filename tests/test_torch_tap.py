"""The port's topology-aware (TAP) halo exchange against the JAX
package's: the host plans byte for byte, the TAP SpMV against the port's
plain SpMV and against JAX's TAP SpMV and its transpose, on the (host,
local) layouts 2 x 4, 4 x 2, 8 x 1 and 1 x 8.

The matrices are the 25^2 rotated anisotropic operator, the 10^3
27-point Laplacian and a seeded ``scipy.sparse.random`` matrix (in place
of the reference's ``random.pm``, which this repository does not hold).
JAX runs on the 8-device CPU mesh of tests/conftest.py with x64.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu.comm import tap as jtap  # noqa: E402
from raptor_tpu.core.par_matrix import par_matrix_from_scipy  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.device import tap_ops as jops  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu_torch.comm import tap as ttap  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.device.tap_ops import tap_spmv, tap_spmv_T  # noqa

from _torch_parity import ANISO, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401


LAYOUTS = [(2, 4), (4, 2), (8, 1), (1, 8)]
MATRICES = ["aniso", "laplacian27", "random"]


def _random_csr(seed=0, n=600, per_row=6):
    """A seeded square random matrix with a full diagonal."""
    m = sp.random(n, n, density=per_row / n, random_state=seed,
                  format="csr") + sp.identity(n, format="csr")
    m = m.tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m


def _jax_matrix(name, n_shards):
    if name == "aniso":
        return jst.par_stencil_grid(jst.diffusion_stencil_2d(*ANISO),
                                    (25, 25), n_shards)
    if name == "laplacian27":
        return jst.par_stencil_grid(jst.laplace_stencil_27pt(),
                                    (10, 10, 10), n_shards)
    return par_matrix_from_scipy(_random_csr(), n_shards)


@pytest.mark.parametrize("hl", LAYOUTS)
@pytest.mark.parametrize("name", MATRICES)
def test_tap_plan_byte_equal(hl, name):
    H, L = hl
    jA = _jax_matrix(name, H * L)
    tA = to_port(jA)
    tp, jp = ttap.build_tap_plan(tA, H, L), jtap.build_tap_plan(jA, H, L)
    for f in dataclasses.fields(jtap.TAPPlanHost):
        t, j = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(j, np.ndarray):
            assert t.dtype == j.dtype and t.shape == j.shape, f.name
            assert t.tobytes() == j.tobytes(), f.name
        else:
            assert t == j, f.name
    assert tp.dcn_values <= tp.dcn_values_plain


def test_tap_dedups_random_matrix():
    """The point of TAP (arXiv:1612.08060): a column that several shards
    of one host need crosses hosts once."""
    tA = to_port(_jax_matrix("random", 8))
    plan = ttap.build_tap_plan(tA, 2, 4)
    assert plan.dcn_values < plan.dcn_values_plain


def test_tap_plan_layout_must_match_shards():
    tA = to_port(_jax_matrix("aniso", 8))
    with pytest.raises(ValueError, match="2 x 2"):
        ttap.build_tap_plan(tA, 2, 2)


def _vectors(jA, dA, seed):
    part = jA.partition
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal(jA.global_num_cols)
    xr = rng.standard_normal(jA.global_num_rows)
    return (xc, xr,
            tpar.device_put_vector(xc, part.col_bounds, dA.cols_pad,
                                   device="cpu"),
            tpar.device_put_vector(xr, part.row_bounds, dA.rows_pad,
                                   device="cpu"))


@pytest.mark.parametrize("hl", LAYOUTS)
@pytest.mark.parametrize("name", MATRICES)
def test_tap_spmv_matches_plain_and_jax(hl, name):
    """tap_spmv equals the port's plain spmv exactly (the same products
    summed in the same order); tap_spmv and tap_spmv_T equal JAX's to
    1e-12 in float64 (the transpose's scatter-adds sum in another
    order)."""
    H, L = hl
    jA = _jax_matrix(name, H * L)
    tA = to_port(jA)
    part = jA.partition
    dA = tpar.device_put_matrix(tA, device="cpu", need_transpose=True)
    T = ttap.device_put_tap(ttap.build_tap_plan(tA, H, L), torch.float64,
                            torch.device("cpu"))
    xc, xr, txc, txr = _vectors(jA, dA, H)
    b = tap_spmv(dA, T, txc)
    assert torch.equal(b, tpar.spmv(dA, txc))
    bt = tap_spmv_T(dA, T, txr)

    mesh = jpar.make_mesh2(H, L)
    jdA = jpar.device_put_matrix(jA, mesh)
    jT = jtap.device_put_tap(jtap.build_tap_plan(jA, H, L), mesh)
    jb = jops.tap_spmv(mesh, jdA, jT, jpar.device_put_vector(
        xc, part.col_bounds, jdA.cols_pad, mesh))
    jbt = jops.tap_spmv_T(mesh, jdA, jT, jpar.device_put_vector(
        xr, part.row_bounds, jdA.rows_pad, mesh))
    got = tpar.host_vector(b, part.row_bounds)
    want = jpar.host_vector(np.asarray(jb), part.row_bounds)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    got_t = tpar.host_vector(bt, part.col_bounds)
    want_t = jpar.host_vector(np.asarray(jbt), part.col_bounds)
    np.testing.assert_allclose(got_t, want_t, rtol=0,
                               atol=1e-12 * np.abs(want_t).max())
    # and both against the host product
    host = tA.global_csr.to_scipy()
    np.testing.assert_allclose(got, host @ xc, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got_t, host.T @ xr, rtol=0,
                               atol=1e-12 * np.abs(want_t).max())


def test_tap_exchange_is_the_plain_exchange():
    """The TAP halo equals the plain one value for value, and its
    transpose adds the same contributions back, on a layout where the
    host-axis transpose is not its own inverse (4 x 2)."""
    jA = _jax_matrix("random", 8)
    tA = to_port(jA)
    dA = tpar.device_put_matrix(tA, device="cpu")
    T = ttap.device_put_tap(ttap.build_tap_plan(tA, 4, 2), torch.float64,
                            torch.device("cpu"))
    _, _, txc, _ = _vectors(jA, dA, 7)
    plain = tpar.halo_exchange(dA, txc)
    tap = ttap.tap_halo_exchange(T, txc)
    n_halo = [len(b.off_proc_column_map) for b in tA.shards()]
    for s, h in enumerate(n_halo):
        assert torch.equal(tap[s, :h], plain[s, :h])
    contrib = torch.from_numpy(np.random.default_rng(3).standard_normal(
        plain.shape))
    for s, h in enumerate(n_halo):
        contrib[s, h:] = 0.0
    back = ttap.tap_halo_exchange_T(T, contrib, dA.cols_pad)
    ref = tpar.halo_exchange_T(dA, contrib, dA.cols_pad)
    torch.testing.assert_close(back, ref, rtol=0, atol=1e-12)


def test_device_put_tap_types_and_transport_raise():
    """A view that holds every shard uploads the same plan; a view of
    fewer shards without the controllers' comm raises (across controllers
    each uploads its shard's row: tests/test_torch_mc_tap.py)."""
    tA = to_port(_jax_matrix("aniso", 8))
    plan = ttap.build_tap_plan(tA, 2, 4)
    cpu = torch.device("cpu")
    T = ttap.device_put_tap(plan, torch.float32, cpu)
    assert T.sendL_mask.dtype == torch.float32
    assert T.sendL_idx.dtype == torch.int64
    assert (T.H, T.L, T.halo_pad) == (2, 4, plan.halo_pad)
    assert T.sub is None
    T2 = ttap.device_put_tap(plan, torch.float32, cpu, first_shard=0,
                             n_local=8)
    for f in ttap._TAP_DATA:
        assert torch.equal(getattr(T2, f), getattr(T, f)), f
    with pytest.raises(ValueError, match="pass their comm"):
        ttap.device_put_tap(plan, torch.float32, cpu, first_shard=4,
                            n_local=4)
