"""The port's hierarchy checkpoint (``multilevel/checkpoint.py``):
tests/test_checkpoint.py::test_checkpoint_roundtrip on the port (the
restored hierarchy solves in the same V-cycles, its residual history
within 1e-10), checkpoints written by either package read by the other to
the same levels bit for bit, and an uneven (k-way) partition coming back
with its row bounds.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.multilevel import checkpoint as jck  # noqa: E402
from raptor_tpu_torch.core.types import CoarsenType, InterpType  # noqa: E402
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.gallery.fem import par_fem  # noqa: E402
from raptor_tpu_torch.gallery.stencils import (  # noqa: E402
    diffusion_stencil_2d, par_stencil_grid)
from raptor_tpu_torch.linalg.repartition import (  # noqa: E402
    partition_graph, repartition_matrix)
from raptor_tpu_torch.multilevel import checkpoint as tck  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import _one_intra_op_thread, port_hierarchy  # noqa: E402,F401,E501


def _setup(A, relax=RelaxType.SOR, sweeps=1):
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=relax)
    ml.num_smooth_sweeps = sweeps
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    return ml


def _same_levels(a, b):
    """Two hierarchies (either package's) with the same levels: row
    bounds, and every A and P bit for bit; the same knobs."""
    assert a.num_levels == b.num_levels
    for la, lb in zip(a.levels, b.levels):
        for ma, mb in ((la.A, lb.A), (la.P, lb.P)):
            if ma is None:
                assert mb is None
                continue
            for f in ("row_bounds", "col_bounds"):
                np.testing.assert_array_equal(getattr(ma.partition, f),
                                              getattr(mb.partition, f))
            ga, gb = ma.global_csr, mb.global_csr
            assert ga.shape == gb.shape
            np.testing.assert_array_equal(ga.indptr, gb.indptr)
            np.testing.assert_array_equal(ga.indices, gb.indices)
            assert np.asarray(ga.data).tobytes() == np.asarray(
                gb.data).tobytes()
    assert a.relax_type.name == b.relax_type.name
    for k in ("solve_tol", "max_iterations", "num_smooth_sweeps",
              "relax_weight"):
        assert getattr(a, k) == getattr(b, k)
    for (l1, p1), (l2, p2) in ((a.coarse_lu, b.coarse_lu),):
        assert l1.tobytes() == l2.tobytes() and p1.tobytes() == p2.tobytes()


def _solve(ml, b):
    dh = DeviceHierarchy(ml, dtype=torch.float64, device="cpu")
    return dh.solve(dh.vector(np.zeros_like(b)), dh.vector(b))


def test_checkpoint_roundtrip(tmp_path):
    A = par_stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (25, 25), 4)
    ml = _setup(A)
    tck.save_hierarchy(ml, tmp_path / "ckpt")
    ml2 = tck.load_hierarchy(tmp_path / "ckpt")
    _same_levels(ml, ml2)
    b = A.mult(np.ones(A.global_num_rows))
    r1, r2 = _solve(ml, b), _solve(ml2, b)
    assert r1.n_iters == r2.n_iters < ml.max_iterations
    np.testing.assert_allclose(r1.res, r2.res, rtol=1e-10)


def test_checkpoints_cross_between_packages(tmp_path):
    """A port-written checkpoint read by the JAX package, and a JAX-written
    one (of the port's hierarchy carried across) read by the port: the
    same levels, bit for bit."""
    A = par_fem("dg_diffusion", 12, 10, 4)
    ml = _setup(A, RelaxType.Chebyshev, 2)
    tck.save_hierarchy(ml, tmp_path / "port")
    jml = jck.load_hierarchy(tmp_path / "port")
    _same_levels(ml, jml)
    jck.save_hierarchy(jml, tmp_path / "jax")
    for f in sorted((tmp_path / "port").iterdir()):
        assert f.read_bytes() == (tmp_path / "jax" / f.name).read_bytes()
    _same_levels(ml, tck.load_hierarchy(tmp_path / "jax"))
    # the JAX hierarchy, carried into the port's containers, saves to the
    # same files
    tck.save_hierarchy(port_hierarchy(jml), tmp_path / "again")
    for f in sorted((tmp_path / "port").iterdir()):
        if f.suffix == ".pm":
            assert f.read_bytes() == (tmp_path / "again" / f.name
                                      ).read_bytes()


def test_uneven_partition_round_trips(tmp_path):
    """A k-way-repartitioned DG operator (uneven shards) set up, saved and
    reloaded keeps every level's row bounds, and the reloaded hierarchy
    packs and solves as the original does."""
    A = par_fem("dg_diffusion", 16, 16, 8)
    A, _ = repartition_matrix(A, partition_graph(A, 8))
    sizes = np.diff(A.partition.row_bounds)
    assert sizes.min() < sizes.max()
    ml = _setup(A, RelaxType.Chebyshev, 2)
    tck.save_hierarchy(ml, tmp_path / "ckpt")
    meta = json.loads((tmp_path / "ckpt" / "meta.json").read_text())
    assert meta["row_bounds"][0] == [int(v) for v in A.partition.row_bounds]
    ml2 = tck.load_hierarchy(tmp_path / "ckpt")
    _same_levels(ml, ml2)
    b = A.mult(np.ones(A.global_num_rows))
    r1, r2 = _solve(ml, b), _solve(ml2, b)
    assert r1.n_iters == r2.n_iters < ml.max_iterations
    np.testing.assert_allclose(r1.res, r2.res, rtol=1e-10)
