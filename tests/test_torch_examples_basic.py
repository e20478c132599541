"""Parity of the basic twins in ``examples_torch/`` (the README example,
the containers, the matrix operations, setup + solve, smoothed
aggregation, blocked AMG) with the JAX package's scripts in
``examples/``: each JAX script runs as it stands, in a subprocess on the
CPU, and its twin's ``main`` runs on the CPU at the same arguments; the
levels, rows and nnz per level and the iteration counts are equal, the
float64 residual histories equal to rtol 1e-6. Times are not compared.

Also: the twins import nothing of JAX, raise without CUDA unless given
``--device cpu``, and ``chip_smoke.py --phases`` parses its selection."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_examples import (REPO, grab, hierarchy, run_jax, run_twin,
                             same_history)
from _torch_parity import _one_intra_op_thread  # noqa: F401

# the twins, one for each of these scripts of examples/
TWINS = ("example", "coo_csr_example", "matop_example", "benchmark_amg",
         "benchmark_pcg", "profile_pcg", "profile_amg", "benchmark_gmres",
         "benchmark_solve", "benchmark_sa", "benchmark_setup_sweeps",
         "benchmark_bsr_amg", "benchmark_setup", "benchmark_spgemm",
         "benchmark_spmv", "benchmark_tap_spmv", "benchmark_tap_amg",
         "model_tap_steps", "profile_comm_levels", "run_multiproc_setup",
         "benchmark_reader", "benchmark_nek5000", "benchmark_tap_setup",
         "benchmark_setup_engines", "benchmark_transfer_formats",
         "benchmark_spmv_sweep", "benchmark_spmv_overlap")
LAUNCH_LINE = "kernel launches: "


def printed(stdout):
    """The twin's lines without the launch counts it adds."""
    return [l for l in stdout.splitlines() if not l.startswith(LAUNCH_LINE)]


@pytest.mark.parametrize("args", [(24, 4), (20, 3)])
def test_example(args):
    """The README run: every printed line equal (levels, the V-cycles and
    each residual at 7 digits, the error at 4), the history to 1e-6."""
    out, rec = run_jax("example.py", *args)
    tout, got = run_twin("example", *args)
    assert printed(tout) == out.splitlines()
    assert [r[1:] for r in hierarchy(out)] == [tuple(l) for l in
                                               got["levels"]]
    assert len(rec) == 1 and got["iterations"] == rec[0]["n_iters"] > 5
    same_history(got["residuals"], rec[0]["res"])


@pytest.mark.parametrize("args", [(64, 64, 4), (48, 32, 3)])
def test_coo_csr_example(args):
    """The random ParCOO: shape, nnz and shards equal, the host norm to
    1e-12 and the device SpMV's to 1e-10 (square only, as in JAX)."""
    out, _ = run_jax("coo_csr_example.py", *args)
    tout, got = run_twin("coo_csr_example", *args)
    assert printed(tout)[0] == out.splitlines()[0]
    host = grab(r"host SpMV  \|Ax\|_2 = (\S+)", out, float)
    np.testing.assert_allclose(got["host_norm"], host, rtol=1e-12)
    dev = grab(r"device SpMV \|Ax\|_2 = (\S+)", out, float)
    if args[0] == args[1]:
        np.testing.assert_allclose(got["device_norm"], dev, rtol=1e-10)
        assert got["max_diff"] < 1e-10
    else:
        assert not dev and "device_norm" not in got
    assert printed(tout)[-1] == "ok"


@pytest.mark.parametrize("args", [(16, 4), (20, 3)])
def test_matop_example(args):
    """Every printed line equal (sizes, nnz, shards, each check's ok)."""
    out, _ = run_jax("matop_example.py", *args)
    tout, got = run_twin("matop_example", *args)
    assert printed(tout) == out.splitlines()
    assert got["n"] == args[0] ** 2


@pytest.mark.parametrize("args", [(24, 4), (24, 4, "f64", "Chebyshev", 2)])
def test_benchmark_amg(args):
    """Setup + the warm solve: the hierarchy, the setup-times table's
    columns and rows, the V-cycles and the nnz a cycle equal; the
    history to 1e-6."""
    out, rec = run_jax("benchmark_amg.py", *args)
    tout, got = run_twin("benchmark_amg", *args)
    assert hierarchy(tout) == hierarchy(out)
    head = grab(r"^(level .*strength)$", out, str)
    assert grab(r"^(level .*strength)$", tout, str) == head and len(head) == 1
    assert (len(grab(r"^\s+\d+  (?:\s+\d+\.\d{4})+$", tout, str))
            == len(grab(r"^\s+\d+  (?:\s+\d+\.\d{4})+$", out, str)) > 1)
    cycles = grab(r"^(\d+) V-cycles in", out)
    assert [got["iterations"]] == cycles == [rec[-1]["n_iters"]]
    assert grab(r"nnz/cycle work: (\d+)", out) == [got["nnz_cycle"]]
    assert len(rec) == 2
    same_history(got["residuals"], rec[-1]["res"])


@pytest.mark.parametrize("args", [(0, 10), (1, 32)])
def test_benchmark_solve(args):
    """System 0 (27-point) and 1 (anisotropic): RS + direct + SOR, b = A
    x_rand; the hierarchy, the warm solve's V-cycles and history."""
    out, rec = run_jax("benchmark_solve.py", *args)
    tout, got = run_twin("benchmark_solve", *args)
    assert hierarchy(tout) == hierarchy(out) and len(hierarchy(out)) > 2
    assert grab(r"\((\d+) V-cycles", out) == [got["iterations"]]
    same_history(got["residuals"], rec[-1]["res"])


def test_benchmark_solve_file_needs_a_path():
    """System 3 reads the file given; without one it says so."""
    from examples_torch import benchmark_solve
    with pytest.raises(SystemExit, match="path"):
        benchmark_solve.main(["3", "--device", "cpu"])


@pytest.mark.parametrize("args", [(12, 4, "f64"), (10, 2, "f64")])
def test_benchmark_sa(args):
    """Smoothed aggregation on the 27-point Laplacian in float64: the
    hierarchy, V-cycles and history."""
    out, rec = run_jax("benchmark_sa.py", *args)
    tout, got = run_twin("benchmark_sa", *args)
    assert hierarchy(tout) == hierarchy(out) and len(hierarchy(out)) > 1
    assert grab(r"; (\d+) V-cycles in", out) == [got["iterations"]]
    same_history(got["residuals"], rec[-1]["res"])


@pytest.mark.parametrize("args", [(16, 8, 2), (12, 12, 1)])
def test_benchmark_bsr_amg(args):
    """Blocked AMG on elasticity: dofs and nnz, the level sizes, the
    blocked V-cycles and BSR-PCG iterations equal, both histories to
    1e-6."""
    out, rec = run_jax("benchmark_bsr_amg.py", *args)
    tout, got = run_twin("benchmark_bsr_amg", *args)
    assert printed(tout)[0] == out.splitlines()[0]
    assert grab(r"levels (\[.*\])", out, str) == [str(got["level_rows"])]
    (bsr,) = [r for r in rec if r["fn"] == "bsr_solve"]
    (pcg,) = [r for r in rec if r["fn"] == "cg"]
    assert grab(r"blocked V-cycle: (\d+) iters", out) == [got["iterations"]]
    assert grab(r"BSR-PCG: (\d+) iters", out) == [got["pcg_iterations"]]
    same_history(got["residuals"], bsr["res"])
    same_history(got["pcg_residuals"], pcg["res"])


@pytest.mark.parametrize("path", sorted(
    (REPO / "examples_torch").glob("*.py")), ids=lambda p: p.name)
def test_twin_imports_nothing_of_jax(path):
    """No file of examples_torch/ imports jax or raptor_tpu."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|raptor_tpu)\b", re.M)
    assert not bad.search(path.read_text())


def test_running_twins_loads_neither_jax_nor_raptor_tpu():
    """Importing every twin and running three of them loads no jax module
    and nothing of raptor_tpu (as the package is held to in
    test_torch_setup.py)."""
    code = r"""
import importlib, sys
sys.path.insert(0, sys.argv[1])
for name in sys.argv[2].split(","):
    importlib.import_module("examples_torch." + name)
from examples_torch import example, matop_example, model_tap_steps
example.main(["12", "2", "--device", "cpu"])
matop_example.main(["8", "2", "--device", "cpu"])
model_tap_steps.main(["16", "2", "2", "--device", "cpu"])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "raptor_tpu" or k.startswith("raptor_tpu."))
assert not bad, bad
"""
    subprocess.run([sys.executable, "-c", code, str(REPO), ",".join(TWINS)],
                   check=True, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_cuda(name, monkeypatch):
    """Each twin of a script of examples/ has a ``main`` that defaults to
    the card and raises without CUDA: it never drops to the CPU unless
    given ``--device cpu``."""
    import importlib
    assert (REPO / "examples" / f"{name}.py").exists()
    mod = importlib.import_module(f"examples_torch.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.mark.parametrize("spec,want", [
    ("21", [1, 2, 21]),
    ("3-5,21", [1, 2, 3, 4, 5, 21]),
    ("9", [1, 2, 6, 8, 9]),
    ("17", [1, 2, 14, 15, 16, 17]),
    (None, list(range(1, 22)))])
def test_chip_smoke_phase_selection(spec, want):
    """``--phases``: 1 (card) and 2 (build) always run, a phase brings the
    phases whose objects it uses, and no selection runs them all."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    assert chip_smoke.select_phases(spec) == want


@pytest.mark.parametrize("spec", ["22", "0", "5-3", "x", "3,,4"])
def test_chip_smoke_rejects_unknown_phases(spec, capsys):
    """An unknown phase or a malformed selection is refused before the
    card is asked for."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phases", spec])
    assert "phase" in capsys.readouterr().err
