"""Packing over uneven shards (ROADMAP Queue 3, F3). The JAX package's
wellt pack breaks when the shards' local column counts straddle a 128
boundary (a ValueError at 257 / 256 / 256, or tile-0 entries repeated and
the transpose path's padding written). The port writes each shard's tiles
into a prefix of the stacked arrays. Held here: the forced sorted-scatter
(wellt) layout of a restriction whose 3 shards hold 257 / 256 / 256 fine
columns, and every automatically chosen format on the levels of a
k-way-repartitioned DG hierarchy (uneven shards), and the forced formats
on its P^T: ``spmv`` and ``spmv_T`` equal the scipy products in float64
to 1e-13 of the largest, every padding row and column of both outputs
exactly zero, and nothing of a shard's layout past its own tiles.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.matrix import CSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.core.types import CoarsenType, InterpType  # noqa: E402
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.linalg.repartition import (  # noqa: E402
    partition_graph, repartition_matrix)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

TOL = 1e-13


def _restriction(n_fine=769, seed=0):
    """A restriction (coarse rows x fine columns) over 3 shards whose
    fine columns split 257 / 256 / 256: each fine point feeds one to three
    coarse points near n_coarse / n_fine of its index."""
    rng = np.random.default_rng(seed)
    nc = n_fine // 3
    cols, rows = [], []
    for j in range(n_fine):
        c = min(nc - 1, j * nc // n_fine)
        for k in range(int(rng.integers(1, 4))):
            rows.append(min(nc - 1, max(0, c + k - 1)))
            cols.append(j)
    m = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(nc, n_fine))
    m.sum_duplicates()
    m.sort_indices()
    part = Partition.create(nc, n_fine, 3)
    assert list(np.diff(part.col_bounds)) == [257, 256, 256]
    return ParCSRMatrix(CSRMatrix.from_scipy(m), part)


def check_products(a: ParCSRMatrix, M, seed=1):
    """M's spmv and spmv_T against a's scipy products, the padding of both
    outputs zero."""
    rng = np.random.default_rng(seed)
    m = a.global_csr.to_scipy()
    rb, cb = a.partition.row_bounds, a.partition.col_bounds
    x = rng.standard_normal(m.shape[1])
    y = rng.standard_normal(m.shape[0])
    xd = tpar.device_put_vector(x, cb, M.cols_pad, device="cpu")
    yd = tpar.device_put_vector(y, rb, M.rows_pad, device="cpu")
    for out, bounds, want in ((tpar.spmv(M, xd), rb, m @ x),
                              (tpar.spmv_T(M, yd), cb, m.T @ y)):
        got = tpar.host_vector(out, bounds)
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale)
        o = out.numpy()
        for s in range(len(bounds) - 1):
            assert not o[s, int(bounds[s + 1] - bounds[s]):].any(), \
                f"padding of shard {s} is not zero"


@pytest.mark.parametrize("lane_pad", [1, 128])
def test_wellt_on_257_256_256_columns(lane_pad):
    a = _restriction()
    M = tpar.device_put_matrix(a, dtype=torch.float64, lane_pad=lane_pad,
                               force_format="wellt", device="cpu")
    assert M.on_format == "wellt"
    # shard 0 holds three 128-column tiles, shards 1 and 2 two each:
    # nothing past a shard's own tiles
    tiles = -(-np.diff(a.partition.col_bounds) // 128)
    vals = M.on_vals.numpy()
    for s, t in enumerate(tiles):
        assert not vals[s, t:].any()
    check_products(a, M)


@pytest.fixture(scope="module")
def dg_hierarchy():
    """A 16 x 16 DG operator k-way-repartitioned into 8 uneven shards, and
    its RS + modified classical hierarchy."""
    A = par_fem("dg_diffusion", 16, 16, 8)
    A, _ = repartition_matrix(A, partition_graph(A, 8))
    sizes = np.diff(A.partition.row_bounds)
    assert sizes.min() < sizes.max()
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    return ml


@pytest.mark.parametrize("lane_pad", [1, 128])
def test_auto_formats_on_kway_dg_levels(dg_hierarchy, lane_pad):
    """Every level's A, P and P^T in the automatically chosen format."""
    formats = set()
    for i, lvl in enumerate(dg_hierarchy.levels):
        ops = [lvl.A] + ([] if lvl.P is None else [lvl.P,
                                                   lvl.P.transpose()])
        for a in ops:
            M = tpar.device_put_matrix(a, dtype=torch.float64,
                                       lane_pad=lane_pad, device="cpu")
            formats.add(M.on_format)
            check_products(a, M, seed=i)
    assert len(formats) > 1


@pytest.mark.parametrize("fmt", ["ell", "well", "wellt", "bell"])
def test_forced_formats_on_kway_dg_restriction(dg_hierarchy, fmt):
    """Level 0's P^T (uneven fine columns) in each forced format."""
    pt = dg_hierarchy.levels[0].P.transpose()
    M = tpar.device_put_matrix(pt, dtype=torch.float64, lane_pad=128,
                               force_format=fmt, device="cpu")
    assert M.on_format == fmt
    check_products(pt, M)
