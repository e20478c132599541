"""Parity of the port's smoothers with the JAX package's
(raptor_tpu.device.relax), on the reference's example hierarchy (24 x 24
rotated anisotropic diffusion, CLJP + modified classical): the native
level schedule and greedy colouring, every leaf of the relaxation plan,
and one call of each of the seven smoothers, in float64 on CPU tensors
(where the DIA/BDIA kernel wrappers run their plain versions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from raptor_tpu import native as jnative  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.device import relax as jrelax  # noqa: E402
from raptor_tpu_torch import native as tnative  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.device import relax as trelax  # noqa: E402

from _torch_parity import jax_rs, to_port  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N = 24
LEAVES = ("diag", "inv_diag", "has_diag", "u_cols", "u_vals", "l_cols",
          "l_vals", "fwd_rows", "fwd_mask", "fwd_cols", "fwd_vals",
          "bwd_rows", "bwd_mask", "bwd_cols", "bwd_vals", "color_mask",
          "inv_l1_diag")
META = ("n_fwd_levels", "n_bwd_levels", "n_colors", "cheb_lo", "cheb_hi")


def _packed(S, lane_pad, level, need=("tri", "color"), force=None):
    """(JAX mesh, A, plan) and (port A, plan) of one level's operator."""
    jh = jax_rs(N, S).levels[level].A
    mesh = jpar.make_mesh(S)
    jA = jpar.device_put_matrix(jh, mesh, dtype=jnp.float64,
                                lane_pad=lane_pad, force_format=force,
                                need_transpose=False)
    jRX = jrelax.build_relax(jh, mesh, jA, dtype=jnp.float64, need=need)
    th = to_port(jh)
    tA = tpar.device_put_matrix(th, lane_pad=lane_pad, force_format=force,
                                need_transpose=False, device="cpu")
    return (mesh, jA, jRX), (tA, trelax.build_relax(th, tA, need=need))


@pytest.mark.parametrize("level", [0, 1, 3])
def test_native_schedule_and_coloring_match_jax(level):
    """level_schedule of both triangles and greedy_coloring of the
    symmetrized pattern, on a fine, a Galerkin and a coarse operator."""
    m = jax_rs(N, 1).levels[level].A.global_csr.to_scipy()
    for tri, reverse in ((sp.tril(m, -1, "csr"), False),
                         (sp.triu(m, 1, "csr"), True)):
        got = tnative.level_schedule(tri.indptr, tri.indices, reverse)
        want = jnative.level_schedule(tri.indptr, tri.indices, reverse)
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0
    sym = (m + m.T).tocsr()
    sym.sort_indices()
    got = tnative.greedy_coloring(sym.indptr, sym.indices)
    np.testing.assert_array_equal(got, jnative.greedy_coloring(sym.indptr,
                                                               sym.indices))
    assert got.min() == 0 and got.max() >= 1


@pytest.mark.parametrize("S", [1, 4])
def test_build_relax_matches_jax(S):
    """Every leaf of the plan equal to JAX's DeviceRelax, on every level,
    with the L/U blocks, both schedules and the colour masks built."""
    for level in range(jax_rs(N, S).num_levels):
        (_, _, jRX), (_, tRX) = _packed(S, 1, level)
        for f in LEAVES:
            got, want = getattr(tRX, f).numpy(), np.asarray(getattr(jRX, f))
            assert got.shape == want.shape, (level, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{level} {f}")
        assert [getattr(tRX, f) for f in META] == \
            [getattr(jRX, f) for f in META]


def test_sweep_plan_matches_schedule():
    """The level-major flat schedule the sweeps read is the JAX layout's,
    shard by shard: rows, columns, values, 1/a_ii and the update mask."""
    (_, _, _), (tA, tRX) = _packed(4, 1, 1)
    S, R = tRX.inv_diag.shape
    for sw, pre in ((tRX.fwd, "fwd"), (tRX.bwd, "bwd")):
        rows = getattr(tRX, f"{pre}_rows")
        NL, M = rows.shape[1:]
        flat = sw.rows.reshape(NL, S, M).transpose(0, 1)
        np.testing.assert_array_equal(
            flat - torch.arange(S)[:, None, None] * R, rows)
        cols = getattr(tRX, f"{pre}_cols")
        np.testing.assert_array_equal(
            sw.cols.reshape(NL, S, M, -1).transpose(0, 1)
            - torch.arange(S)[:, None, None, None] * R, cols)
        np.testing.assert_array_equal(
            sw.vals.reshape(NL, S, M, -1).transpose(0, 1),
            getattr(tRX, f"{pre}_vals"))
        ok = getattr(tRX, f"{pre}_mask") * torch.gather(
            tRX.has_diag, 1, rows.reshape(S, -1)).reshape(S, NL, M) > 0
        np.testing.assert_array_equal(
            sw.ok.reshape(NL, S, M).transpose(0, 1), ok)
        assert sw.ok.any() and not sw.ok.all()


@pytest.mark.parametrize("S,lane_pad,level,fmt", [
    (1, 128, 0, "dia"), (4, 128, 1, "bdia"), (4, 1, 2, "ell")])
@pytest.mark.parametrize("kind", list(trelax.RELAX_FNS))
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_smoother_matches_jax(S, lane_pad, level, fmt, kind, omega):
    """Two sweeps of each smoother from a random x: equal to JAX's
    ``relax`` to 1e-12 relative, on the DIA fine operator and on Galerkin
    operators packed as BDIA and, forced, as ELL."""
    (mesh, jA, jRX), (tA, tRX) = _packed(
        S, lane_pad, level, force="ell" if fmt == "ell" else None)
    assert tA.on_format == jA.on_format == fmt
    part = jax_rs(N, S).levels[level].A.partition
    rng = np.random.default_rng(S + level)
    x, b = rng.standard_normal((2, part.global_num_rows))
    jx, jb = (jpar.device_put_vector(v, part.row_bounds, jA.rows_pad, mesh)
              for v in (x, b))
    tx, tb = (tpar.device_put_vector(v, part.row_bounds, tA.rows_pad,
                                     device="cpu") for v in (x, b))
    want = np.asarray(jrelax.relax(mesh, kind, jA, jRX, jx, jb,
                                   num_sweeps=2, omega=omega))
    got = trelax.RELAX_FNS[kind](tA, tRX, tx, tb, 2, omega).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
