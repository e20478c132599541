"""Parity of the matrix-file and node-aware setup twins in
``examples_torch/`` (``benchmark_reader``, ``benchmark_nek5000``,
``benchmark_tap_setup``) with the JAX package's scripts in ``examples/``,
run as ``test_torch_examples_basic.py`` runs them: the files each reads
written by the port's writers, the shape, nnz and format, the partitions'
halo values and edge cuts, the hierarchy, the PCG iterations and float64
history, and the setup's sends across nodes and levels equal. Times are
not compared."""

import numpy as np
import pytest

pytest.importorskip("torch")

from _torch_examples import grab, hierarchy, run_jax, run_twin, same_history
from _torch_parity import _one_intra_op_thread  # noqa: F401
from raptor_tpu_torch.gallery import io
from raptor_tpu_torch.gallery.dg import dg_diffusion
from raptor_tpu_torch.gallery.stencils import (diffusion_stencil_2d,
                                               stencil_grid)

READ = r"^read \S+: (\d+) x (\d+), nnz (\d+)"


def aniso(n):
    return stencil_grid(diffusion_stencil_2d(0.001, np.pi / 8), (n, n))


@pytest.mark.parametrize("kind,n_shards", [("pm", 1), ("mtx", 1),
                                           ("pm", 4)])
def test_benchmark_reader(tmp_path, kind, n_shards):
    """The flagship's 32^2 operator written by the port as .pm or .mtx:
    the shape, nnz and format the JAX script reports."""
    path = tmp_path / f"aniso32.{kind}"
    (io.write_pm if kind == "pm" else io.write_mm)(path, aniso(32))
    out, _ = run_jax("benchmark_reader.py", path, n_shards)
    tout, got = run_twin("benchmark_reader", path, n_shards)
    shape = grab(READ, out)
    assert shape == grab(READ, tout) == [
        (got["n_rows"], got["n_cols"], got["nnz"])]
    assert grab(r"^format (\w+);", out, str) == [got["format"]]


def test_reader_files_byte_equal(tmp_path):
    """The port's .pm and .mtx writers give the JAX package's bytes, so
    both scripts read the same file."""
    from raptor_tpu.gallery import io as jio
    from raptor_tpu.gallery.dg import dg_diffusion as jdg
    for ext, tw, jw in (("pm", io.write_pm, jio.write_pm),
                        ("mtx", io.write_mm, jio.write_mm)):
        tw(tmp_path / f"t.{ext}", dg_diffusion(6, 6, 10.0))
        jw(tmp_path / f"j.{ext}", jdg(6, 6, 10.0))
        assert ((tmp_path / f"t.{ext}").read_bytes()
                == (tmp_path / f"j.{ext}").read_bytes())


def test_reader_default_path_absent():
    """The JAX script's default file, the reference's aniso.pm, lies
    outside the repository: without a path the twin stops with a usage
    error that names it, whatever lies around the checkout."""
    from examples_torch import benchmark_reader
    with pytest.raises(SystemExit, match="aniso.pm"):
        benchmark_reader.main(["--device", "cpu"])


@pytest.mark.parametrize("n", [8])
def test_benchmark_nek5000(tmp_path, n):
    """SIPG DG diffusion at n^2 elements as .mtx over 4 shards: the three
    partitions' halo values and edge cuts, the k-way repartitioned
    hierarchy, the float64 AMG-PCG's iterations (its cap of 200 in both:
    the default SOR(1) preconditioner is not symmetric) and its history
    equal."""
    path = tmp_path / f"dg{n}.mtx"
    io.write_mm(path, dg_diffusion(n, n, 10.0))
    out, rec = run_jax("benchmark_nek5000.py", path)
    tout, got = run_twin("benchmark_nek5000", path)
    assert grab(READ, tout) == grab(READ, out) == [
        (got["n_rows"], got["n_rows"], got["nnz"])]
    part = (r"^partition halo_values: naive (\d+), rcm (\d+), kway (\d+) "
            r"\(edge cut (\d+)/(\d+)/(\d+);")
    h, c = got["halo_values"], got["edge_cut"]
    assert grab(part, out) == grab(part, tout) == [
        (h["naive"], h["rcm"], h["kway"], c["naive"], c["rcm"], c["kway"])]
    assert hierarchy(tout) == hierarchy(out) and len(hierarchy(out)) > 2
    assert [(r, z) for _, r, z in hierarchy(out)] == got["levels"]
    assert grab(r"^AMG-PCG: (\d+) iters", out) == [got["pcg_iterations"]]
    assert rec[-1]["fn"] == "cg"
    same_history(got["residuals"], rec[-1]["res"])


def test_nek5000_default_path_absent():
    """The JAX script's default file, the reference's LFAT5.mtx, lies
    outside the repository: without a path the twin stops with a usage
    error that names it, whatever lies around the checkout."""
    from examples_torch import benchmark_nek5000
    with pytest.raises(SystemExit, match="LFAT5.mtx"):
        benchmark_nek5000.main(["--device", "cpu"])


def test_nek5000_final_residual_hold(tmp_path):
    """chip_smoke.py's hold on nek5000's PCG at phase 21's size (DG 64^2
    elements, which stops at its cap of 200): the port's float64 solve on
    the CPU meets JAX's final residual, and the same solve in float32
    fails it."""
    import chip_smoke
    import torch
    from examples_torch import benchmark_nek5000
    want, rtol = chip_smoke.EX_FINAL_RES["benchmark_nek5000"]
    n = chip_smoke.EX_DG_N
    path = tmp_path / f"dg{n}.mtx"
    io.write_mm(path, dg_diffusion(n, n, chip_smoke.DG_SIGMA))
    _, got = run_twin("benchmark_nek5000", path)
    assert got["pcg_iterations"] == 200
    chip_smoke.final_res_held("nek5000", got["residuals"], want, rtol)
    dh = benchmark_nek5000.DeviceHierarchy
    try:
        benchmark_nek5000.DeviceHierarchy = (
            lambda ml, **kw: dh(ml, dtype=torch.float32, **kw))
        _, f32 = run_twin("benchmark_nek5000", path)
    finally:
        benchmark_nek5000.DeviceHierarchy = dh
    with pytest.raises(AssertionError, match="final relative residual"):
        chip_smoke.final_res_held("nek5000", f32["residuals"], want, rtol)


@pytest.mark.parametrize("spans, want", [
    ([], 0.0), ([(0, 5), (3, 8), (10, 12), (11, 11.5)], 10.0),
    ([(4, 6), (0, 10)], 10.0)])
def test_chip_smoke_busy_us(spans, want):
    """The overlap trace's device busy time: the union of the spans."""
    import chip_smoke
    assert chip_smoke.busy_us(spans) == want


@pytest.mark.parametrize("args", [(24, 4, 2), (16, 4, 4)])
def test_benchmark_tap_setup(args):
    """The distributed RS setup over 4 forked processes, flat and through
    TapGroup: the sends across nodes and the levels equal, TAP's fewer
    when there are two nodes."""
    out, _ = run_jax("benchmark_tap_setup.py", *args)
    tout, got = run_twin("benchmark_tap_setup", *args)
    pat = (r"^ *(flat|TAP \(2-step\)): setup max [\d.]+s, inter-node sends "
           r"(\d+), (\d+) levels \((.*)\)$")
    rows = grab(pat, out, str)
    assert grab(pat, tout, str) == rows and len(rows) == 2
    assert [(int(r[1]), int(r[2])) for r in rows] == [
        (got[k]["inter_node_sends"], got[k]["levels"])
        for k in ("flat", "tap")]
    if args[1] // args[2] > 1:
        assert got["tap"]["inter_node_sends"] < got["flat"][
            "inter_node_sends"]
