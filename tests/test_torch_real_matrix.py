"""The real-matrix path end to end at 32^2 DG elements on 8 shards, in the
port and in the JAX package (the reference's
examples/benchmark_nek5000.py flow): the SIPG DG diffusion operator
written to a ``.pm`` file and read back, k-way partitioned and migrated,
its shards placed by the 2 x 4 ``Topology``, diagonally scaled, set up
(RS + modified classical, theta 0.25, Chebyshev(2)), checkpointed and
reloaded, and solved by float64 AMG-PCG to 1e-8 on the stacked shards
(the port's on CPU tensors). Both packages give the same shard bounds,
levels and nnz, the same iterations, and x within 1e-10 relative; the
unscaled, unpermuted x solves the original system.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.core import topology as jtopo  # noqa: E402
from raptor_tpu.core.types import CoarsenType as JC  # noqa: E402
from raptor_tpu.core.types import InterpType as JI  # noqa: E402
from raptor_tpu.core.types import RelaxType as JR  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.gallery import io as jio  # noqa: E402
from raptor_tpu.gallery.dg import dg_diffusion as jdg  # noqa: E402
from raptor_tpu.krylov.cg import cg as jcg  # noqa: E402
from raptor_tpu.linalg import diag_scale as jds  # noqa: E402
from raptor_tpu.linalg import repartition as jrep  # noqa: E402
from raptor_tpu.multilevel import checkpoint as jck  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JDH)
from raptor_tpu.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver as JRS)
from raptor_tpu_torch.core import topology as ttopo  # noqa: E402
from raptor_tpu_torch.core.types import CoarsenType, InterpType  # noqa: E402
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.gallery import io as tio  # noqa: E402
from raptor_tpu_torch.gallery.dg import dg_diffusion  # noqa: E402
from raptor_tpu_torch.krylov.cg import cg  # noqa: E402
from raptor_tpu_torch.linalg import diag_scale as tds  # noqa: E402
from raptor_tpu_torch.linalg import repartition as trep  # noqa: E402
from raptor_tpu_torch.multilevel import checkpoint as tck  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N, SHARDS, PPN = 32, 8, 4


def _pipeline(pkg, tmp):
    """One package's path: returns (operators along the way, the hierarchy,
    the PCG result's iterations and history, x on the original rows)."""
    if pkg == "port":
        io, rep, topo, ds, ck = tio, trep, ttopo, tds, tck
        gal = dg_diffusion
        ml = ParRugeStubenSolver(0.25, CoarsenType.RS,
                                 InterpType.ModClassical,
                                 relax_type=RelaxType.Chebyshev)
    else:
        io, rep, topo, ds, ck = jio, jrep, jtopo, jds, jck
        gal = jdg
        ml = JRS(0.25, JC.RS, JI.ModClassical, relax_type=JR.Chebyshev)
    io.write_pm(tmp / "dg.pm", gal(N, N))
    A0 = io.read_par_pm(tmp / "dg.pm", SHARDS)
    n = A0.global_num_rows
    b0 = A0.mult(np.ones(n))
    A1, p1 = rep.repartition_matrix(A0, rep.partition_graph(A0, SHARDS))
    A2, p2 = topo.reorder_shards(A1, topo.Topology(SHARDS, ppn=PPN))
    perm = p1[p2]
    As, bs, scales = ds.diagonally_scale(A2, b0[perm])
    ml.num_smooth_sweeps = 2
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(As)
    ck.save_hierarchy(ml, tmp / "ckpt")
    ml = ck.load_hierarchy(tmp / "ckpt")
    if pkg == "port":
        dh = DeviceHierarchy(ml, dtype=torch.float64, device="cpu")
        r = cg(dh.levels[0].A, dh.vector(np.zeros(n)), dh.vector(bs),
               tol=1e-8, max_iter=200, precond=dh.precond_pack())
        k, res = r.n_iters, np.asarray(r.res)
    else:
        mesh = jpar.make_mesh(SHARDS)
        dh = JDH(ml, mesh, dtype=jnp.float64)
        r = jcg(mesh, dh.levels[0].A, dh.vector(np.zeros(n)),
                dh.vector(bs), tol=1e-8, max_iter=200,
                precond=dh.precond_pack())
        k, res = int(r.n_iters), np.asarray(r.res)
    x = np.empty(n)
    x[perm] = ds.diagonally_unscale(dh.host(r.x), scales)
    return (A0, A2, As), ml, k, res, x, b0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {pkg: _pipeline(pkg, tmp_path_factory.mktemp(pkg))
            for pkg in ("port", "jax")}


def test_real_matrix_path_matches_jax(runs):
    (tops, tml, tk, tres, tx, b0), (jops, jml, jk, jres, jx, _) = (
        runs["port"], runs["jax"])
    for t, j in zip(tops, jops):
        np.testing.assert_array_equal(t.partition.row_bounds,
                                      j.partition.row_bounds)
        tg, jg = t.global_csr, j.global_csr
        np.testing.assert_array_equal(tg.indices, jg.indices)
        assert tg.data.tobytes() == jg.data.tobytes()
    # the k-way shards are uneven, and moved by the partition
    sizes = np.diff(tops[1].partition.row_bounds)
    assert sizes.min() < sizes.max()
    assert tml.num_levels == jml.num_levels > 2
    for tl, jl in zip(tml.levels, jml.levels):
        assert tl.A.nnz == jl.A.nnz
        np.testing.assert_array_equal(tl.A.partition.row_bounds,
                                      jl.A.partition.row_bounds)
    assert tk == jk < 200
    assert tres[tk] < 1e-8
    np.testing.assert_allclose(tres[:tk + 1], jres[:jk + 1], rtol=1e-6)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-10 * np.abs(jx).max())
    A0 = tops[0]
    assert (np.linalg.norm(b0 - A0.mult(tx)) / np.linalg.norm(b0)) < 1e-7
