"""Parity of the port's device formats and sharded SpMV with the JAX
package: the packed arrays byte for byte, and spmv / residual / spmv_T in
float64, at 1 and 8 shards and with lane padding 1 and 128, on the
flagship 64 x 64 anisotropic hierarchy.

JAX runs as its own tests run it: on the 8-device CPU mesh of
tests/conftest.py, where its DIA/BDIA SpMVs go through their XLA versions.
``RAPTOR_TPU_WELL=0`` keeps JAX to its structural format rules: its
transfer-format rescue ranks by TPU timing constants where the port ranks
by bytes (tests/test_torch_transfer.py compares the transfer formats).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.comm import plan as jplan  # noqa: E402
from raptor_tpu.device import formats as jfmt  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu_torch.comm import plan as tplan  # noqa: E402
from raptor_tpu_torch.device import formats as tfmt  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402

from _torch_parity import jax_hierarchy, to_port  # noqa: E402

N = 64
# (name, level, operator, embed, force_format)
MATRICES = [
    ("A0", 0, "A", None, None),          # stencil: DIA
    ("A3", 3, "A", None, None),          # coarse Galerkin: BDIA at S=1
    ("A3ell", 3, "A", None, "ell"),      # the ELL path
    ("P0", 0, "P", "cols", None),        # embedded DIA prolongator
    ("Pt0", 0, "Pt", "rows", None),      # embedded DIA restriction
    ("P2", 2, "P", "cols", None),        # BDIA prolongator
    ("Pt2", 2, "Pt", "rows", None),      # BDIA restriction
]
SHARDS = [1, 8]
LANE_PADS = [1, 128]


def _host_matrix(S, level, op):
    lvl = jax_hierarchy(N, S).levels[level]
    return {"A": lvl.A, "P": lvl.P, "Pt": lvl.P.transpose()
            if lvl.P is not None else None}[op]


def _pair(monkeypatch, S, lane_pad, level, op, embed, force):
    """The same matrix packed by both packages."""
    monkeypatch.setenv("RAPTOR_TPU_WELL", "0")
    m = _host_matrix(S, level, op)
    jA = jpar.device_put_matrix(m, jpar.make_mesh(S), dtype=jnp.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=force)
    tA = tpar.device_put_matrix(to_port(m), dtype=torch.float64,
                                lane_pad=lane_pad, embed=embed,
                                force_format=force, device="cpu")
    return m, jA, tA


# fields of the JAX plan the port carries, compared value for value
_FIELDS = ["on_cols", "on_vals", "off_rows", "off_cols", "off_vals",
           "dia_vals", "bd_idx", "bd_vals", "rest_rows", "rest_cols",
           "rest_vals", "emb_idx", "emb_mask", "send_idx", "send_mask",
           "halo_src", "slot_to_halo", "recv_mask", "row_mask"]
_META = ["rows_pad", "cols_pad", "halo_pad", "dia_pad",
         "dia_offsets", "bd_offsets", "bd_padb", "bd_ba", "on_format",
         "embed_kind", "on_rows_pad", "has_t", "global_num_rows",
         "global_num_cols"]


@pytest.mark.parametrize("lane_pad", LANE_PADS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed,force", MATRICES)
def test_packed_plan_equals_jax(monkeypatch, S, lane_pad, name, level, op,
                                embed, force):
    _, jA, tA = _pair(monkeypatch, S, lane_pad, level, op, embed, force)
    for f in _META:
        assert getattr(tA, f) == getattr(jA, f), f
    for f in _FIELDS:
        j = np.asarray(getattr(jA, f))
        t = getattr(tA, f).numpy()
        assert t.shape == j.shape, f
        if j.dtype.kind == "f":
            assert t.dtype == j.dtype and t.tobytes() == j.tobytes(), f
        else:   # index arrays: int64 in the port, int32/int8 in JAX
            np.testing.assert_array_equal(t, j, err_msg=f)
    assert tuple(tA.dia_off.tolist()) == tA.dia_offsets
    assert tuple(tA.bd_off.tolist()) == tA.bd_offsets


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed,force", MATRICES)
def test_packers_byte_equal(S, name, level, op, embed, force):
    """Each NumPy packer, called on the same blocks, returns the same
    bytes in both packages."""
    m = _host_matrix(S, level, op)
    tm = to_port(m)
    jplan_ = jplan.build_comm_plan(m, lane_pad=128)
    tplan_ = tplan.build_comm_plan(tm, lane_pad=128)
    for f in ("send_idx", "send_mask", "halo_src", "halo_mask",
              "slot_to_halo", "recv_mask", "n_halo"):
        assert getattr(jplan_, f).tobytes() == getattr(tplan_, f).tobytes()
    assert (jplan_.slot, jplan_.halo_pad) == (tplan_.slot, tplan_.halo_pad)
    for jb, tb in zip(m.shards(), tm.shards()):
        j_on, t_on = jb.on_proc, tb.on_proc
        R = j_on.n_rows + 5
        for a, b in zip(jfmt.ell_arrays(j_on, R), tfmt.ell_arrays(t_on, R)):
            assert a.tobytes() == b.tobytes()
        W = max(1, int(np.diff(jb.off_proc.indptr).max(initial=0)))
        B = max(1, int(np.count_nonzero(np.diff(jb.off_proc.indptr))))
        for a, b in zip(
                jfmt.ell_boundary_arrays(jb.off_proc, W, B, R),
                tfmt.ell_boundary_arrays(tb.off_proc, W, B, R)):
            assert a.tobytes() == b.tobytes()
        offs = jfmt.dia_detect(j_on, 10**6)
        assert np.array_equal(offs, tfmt.dia_detect(t_on, 10**6))
        assert jfmt.dia_arrays(j_on, offs, R, np.float32).tobytes() == \
            tfmt.dia_arrays(t_on, offs, R, np.float32).tobytes()
        jp, jc = jfmt.bdia_plane_counts(j_on)
        tp, tc = tfmt.bdia_plane_counts(t_on)
        assert jp == tp and jc.tobytes() == tc.tobytes()
        a128 = -(-R // 128)
        spec = jfmt.select_planes(dict(zip(jp, jc)), 16, a128)
        assert spec == tfmt.select_planes(dict(zip(tp, tc)), 16, a128)
        if spec:
            for a, b in zip(jfmt.bdia_arrays(j_on, spec, a128 + 1),
                            tfmt.bdia_arrays(t_on, spec, a128 + 1)):
                assert a.tobytes() == b.tobytes()
        jr, tr = jfmt.bdia_split_rest(j_on, spec), \
            tfmt.bdia_split_rest(t_on, spec)
        for f in ("indptr", "indices", "data"):
            assert getattr(jr, f).tobytes() == getattr(tr, f).tobytes()


def _vectors(rng, m, jA, tA, S):
    """Random x over the columns and b over the rows, in both layouts."""
    part = m.partition
    x = rng.standard_normal(part.global_num_cols)
    b = rng.standard_normal(part.global_num_rows)
    mesh = jpar.make_mesh(S)
    jx = jpar.device_put_vector(x, part.col_bounds, jA.cols_pad, mesh)
    jb = jpar.device_put_vector(b, part.row_bounds, jA.rows_pad, mesh)
    tx = tpar.device_put_vector(x, part.col_bounds, tA.cols_pad,
                                device="cpu")
    tb = tpar.device_put_vector(b, part.row_bounds, tA.rows_pad,
                                device="cpu")
    return mesh, jx, jb, tx, tb


def _rel(t, j):
    j = np.asarray(j)
    return float(np.abs(t.numpy() - j).max() / max(np.abs(j).max(), 1e-300))


@pytest.mark.parametrize("lane_pad", LANE_PADS)
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed,force", MATRICES)
def test_spmv_residual_match_jax(monkeypatch, S, lane_pad, name, level, op,
                                 embed, force):
    m, jA, tA = _pair(monkeypatch, S, lane_pad, level, op, embed, force)
    assert tA.on_format == jA.on_format
    rng = np.random.default_rng(level * 10 + S)
    mesh, jx, jb, tx, tb = _vectors(rng, m, jA, tA, S)
    assert _rel(tpar.spmv(tA, tx), jpar.spmv(mesh, jA, jx)) <= 1e-12
    assert _rel(tpar.residual(tA, tx, tb),
                jpar.residual(mesh, jA, jx, jb)) <= 1e-12


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name,level,op,embed,force", MATRICES)
def test_spmv_T_matches_jax(monkeypatch, S, name, level, op, embed, force):
    m, jA, tA = _pair(monkeypatch, S, 128, level, op, embed, force)
    rng = np.random.default_rng(level * 10 + S + 1)
    part = m.partition
    y = rng.standard_normal(part.global_num_rows)
    mesh = jpar.make_mesh(S)
    jy = jpar.device_put_vector(y, part.row_bounds, jA.rows_pad, mesh)
    ty = tpar.device_put_vector(y, part.row_bounds, tA.rows_pad,
                                device="cpu")
    assert _rel(tpar.spmv_T(tA, ty), jpar.spmv_T(mesh, jA, jy)) <= 1e-12


def test_spmv_matches_host_product():
    """The port alone against scipy, in float32 and float64 (kernel
    wrappers on CPU tensors run the plain versions)."""
    m = _host_matrix(8, 0, "A")
    tA64 = tpar.device_put_matrix(to_port(m), lane_pad=128, device="cpu")
    tA32 = tpar.device_put_matrix(to_port(m), dtype=torch.float32,
                                  lane_pad=128, device="cpu")
    x = np.random.default_rng(5).standard_normal(m.global_num_cols)
    want = m.global_csr.to_scipy() @ x
    part = m.partition
    for tA, tol in ((tA64, 1e-13), (tA32, 1e-6)):
        tx = tpar.device_put_vector(x, part.col_bounds, tA.cols_pad,
                                    dtype=tA.dtype, device="cpu")
        got = tpar.host_vector(tpar.spmv(tA, tx), part.row_bounds)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_later_formats_raise():
    """A format the port does not pack is refused, not ignored."""
    m = to_port(_host_matrix(1, 0, "P"))
    for f in ("dia", "bdia", "csr", "WELL"):
        with pytest.raises(ValueError, match="force_format"):
            tpar.device_put_matrix(m, force_format=f, device="cpu")
