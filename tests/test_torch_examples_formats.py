"""Parity of the setup-engine, transfer-format, L2-sweep and overlap twins
in ``examples_torch/`` (``benchmark_setup_engines``,
``benchmark_transfer_formats``, ``benchmark_spmv_sweep``,
``benchmark_spmv_overlap``) with the JAX package.

The engines, sweep and overlap scripts run as they stand in a subprocess
(``tests/_torch_examples.py``): the operator sizes, the interpolation's
pattern and nnz, the sweep's format of each size and the printed lines
are compared. The JAX transfer-formats script spends minutes in its
timing loops on the CPU (the Pallas kernels in interpret mode), so its
twin is held to JAX's pack-and-apply functions instead
(``device_put_matrix`` with ``force_format``, then ``spmv``) on the
operators the twin built, which are held to JAX's hierarchy's. The
overlap's product is held to JAX's ``spmv`` and bit for bit to the port's
``spmv``. Times are not compared."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_examples import grab, run_jax, run_twin  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401
from raptor_tpu.core.par_matrix import ParCSRMatrix as JParCSR  # noqa: E402
from raptor_tpu.core.partition import Partition as JPartition  # noqa: E402
from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix  # noqa: E402
from raptor_tpu_torch.core.partition import Partition  # noqa: E402
from raptor_tpu_torch.device import par as tpar  # noqa: E402

FORCED = ("well", "wellt", "bell", "ell")


def _rel(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("args", [(16, 3), (32, 2, "RS", "ModClassical")])
def test_benchmark_setup_engines(args):
    """Host against card engines on level 0: the operator, the
    interpolation's pattern equal in both packages with the same nnz, the
    twin's P and coarse operator within 1e-10 of the host's."""
    out, _ = run_jax("benchmark_setup_engines.py", *args)
    tout, got = run_twin("benchmark_setup_engines", *args)
    size = r"^A: (\d+) rows, (\d+) nnz"
    assert grab(size, out) == grab(size, tout) == [(got["rows"],
                                                    got["nnz"])]
    pat = r"pattern_eq=(\w+) max\|dv\|=\S+ nnz=(\d+)"
    assert grab(pat, out, str) == [("True", str(got["p_nnz"]))]
    assert grab(pat, tout, str) == grab(pat, out, str)
    assert got["pattern_eq"] and got["max_dv"] <= 1e-10
    labels = r"^  (host native|device) (.+?)\s+[\d.]+s$"
    assert grab(labels, tout, str) == grab(labels, out, str)


@pytest.fixture(scope="module")
def formats_run(tmp_path_factory):
    """The twin at 12^3 (its P and P^T cached in a temporary directory),
    its printed lines, counts and the cached operators."""
    from examples_torch.benchmark_transfer_formats import build_or_load
    cache = tmp_path_factory.mktemp("transfer")
    tout, got = run_twin("benchmark_transfer_formats", 12, cache)
    return tout, got, build_or_load(12, str(cache), "cpu")


def test_transfer_operators_are_jax_hierarchy(formats_run):
    """The cached level-0 P and P^T are those of the JAX package's 12^3
    PMIS + extended+i hierarchy."""
    from raptor_tpu.core.types import CoarsenType, InterpType
    from raptor_tpu.gallery.stencils import (laplace_stencil_27pt,
                                             par_stencil_grid)
    from raptor_tpu.multilevel.par_multilevel import ParRugeStubenSolver
    ml = ParRugeStubenSolver(0.25, CoarsenType.PMIS, InterpType.Extended)
    ml.setup(par_stencil_grid(laplace_stencil_27pt(), (12, 12, 12), 1))
    want = {"P": ml.levels[0].P._g(),
            "Pt": ml.levels[0].P.transpose()._g()}
    for k, op in formats_run[2].items():
        assert op.shape == want[k].shape
        assert np.array_equal(op.indptr, want[k].indptr)
        assert np.array_equal(op.indices, want[k].indices)
        assert _rel(op.data, want[k].data) <= 1e-12


@pytest.mark.parametrize("name,embed", [("P", "cols"), ("Pt", "rows")])
def test_transfer_formats(formats_run, name, embed):
    """Each format of the twin's run within 1e-4 of the host product;
    each forced format packed as forced in both packages, with float32
    products equal to JAX's to 1e-6 relative; auto held to the host
    product only (the port ranks formats by bytes, JAX by its TPU
    constants)."""
    tout, got, ops = formats_run
    rows = got[name]
    assert list(rows) == ["auto", *FORCED]
    assert all(r["err"] < 1e-4 for r in rows.values())
    a = ops[name]
    head = rf"^== {name}: (\d+) x (\d+), nnz (\d+) ==$"
    assert grab(head, tout) == [(a.n_rows, a.n_cols, a.nnz)]
    xh = np.random.default_rng(0).random(a.n_cols)
    mesh = jpar.make_mesh(1)
    from raptor_tpu.core.matrix import CSRMatrix as JCSR
    ja = JParCSR(JCSR(a.n_rows, a.n_cols, a.indptr, a.indices, a.data),
                 JPartition.create(a.n_rows, a.n_cols, 1))
    ta = ParCSRMatrix(a, Partition.create(a.n_rows, a.n_cols, 1))
    for fmt in FORCED:
        kw = dict(lane_pad=128, need_transpose=False, embed=embed,
                  force_format=fmt)
        jA = jpar.device_put_matrix(ja, mesh, dtype=jnp.float32, **kw)
        jx = jpar.device_put_vector(xh, ja.partition.col_bounds,
                                    jA.cols_pad, mesh, dtype=jnp.float32)
        jy = jpar.host_vector(np.asarray(jpar.spmv(mesh, jA, jx)),
                              ja.partition.row_bounds)
        tA = tpar.device_put_matrix(ta, dtype=torch.float32, device="cpu",
                                    **kw)
        tx = tpar.device_put_vector(xh, ta.partition.col_bounds,
                                    tA.cols_pad, dtype=torch.float32,
                                    device="cpu")
        ty = tpar.host_vector(tpar.spmv(tA, tx), ta.partition.row_bounds)
        assert tA.on_format == jA.on_format == rows[fmt]["format"] == fmt
        assert _rel(ty, jy) <= 1e-6, fmt
        line = rf"^  {fmt}\({fmt}\)\s+:\s+[\d.]+ ms/apply  \(err (\S+)\)$"
        assert len(grab(line, tout, str)) == 2


def test_benchmark_spmv_sweep():
    """f64 at 8^3 and 12^3 on one shard: each size's nnz and format the
    JAX script's, both rates reported with the flush's size."""
    args = ("f64", 8, 12)
    out, _ = run_jax("benchmark_spmv_sweep.py", *args)
    tout, got = run_twin("benchmark_spmv_sweep", *args)
    line = (r"^(\d+)\^3 \(([\d.]+)M nnz, (\w+)\): resident [\d.]+ Gnnz/s, "
            r"cleared-chain [\d.]+ Gnnz/s \(incl\. (\d+) MB flush/rep\)$")
    rows = grab(line, out, str)
    assert grab(line, tout, str) == rows and len(rows) == 2
    assert [(int(r[0]), r[2]) for r in rows] == [
        (n, v["format"]) for n, v in got["sizes"].items()]
    assert got["flush_mb"] == 8 and got["l2_bytes"] is None


def test_benchmark_spmv_overlap():
    """The 27-point operator at 16^3 over 8 shards: the JAX script's three
    lines; the twin's two orders bit-equal, and ``spmv_overlap`` equal to
    JAX's ``spmv`` to 1e-6 relative in float32 and bit for bit to the
    port's ``spmv``."""
    from raptor_tpu.gallery.stencils import (laplace_stencil_27pt as jlap,
                                             par_stencil_grid as jgrid)
    from raptor_tpu_torch.gallery.stencils import (laplace_stencil_27pt,
                                                   par_stencil_grid)
    out, _ = run_jax("benchmark_spmv_overlap.py", 16)
    tout, got = run_twin("benchmark_spmv_overlap", 16)
    lines = r"^(overlapped |serialized |overlap gain)"
    assert grab(lines, tout, str) == grab(lines, out, str)
    assert len(grab(lines, out, str)) == 3 and got["bit_equal"]

    xh = np.random.default_rng(0).random(16 ** 3)
    mesh = jpar.make_mesh(8)
    jA0 = jgrid(jlap(), (16, 16, 16), 8)
    jA = jpar.device_put_matrix(jA0, mesh, dtype=jnp.float32, lane_pad=128)
    jx = jpar.device_put_vector(xh, jA0.partition.col_bounds, jA.cols_pad,
                                mesh, dtype=jnp.float32)
    jy = np.asarray(jpar.spmv(mesh, jA, jx))
    tA0 = par_stencil_grid(laplace_stencil_27pt(), (16, 16, 16), 8)
    tA = tpar.device_put_matrix(tA0, dtype=torch.float32, lane_pad=128,
                                device="cpu")
    tx = tpar.device_put_vector(xh, tA0.partition.col_bounds, tA.cols_pad,
                                dtype=torch.float32, device="cpu")
    ty = tpar.spmv_overlap(tA, tx)
    assert tA.on_format == jA.on_format == got["format"]
    assert torch.equal(ty, tpar.spmv(tA, tx))
    bounds = tA0.partition.row_bounds
    assert _rel(tpar.host_vector(ty, bounds),
                jpar.host_vector(jy, bounds)) <= 1e-6
