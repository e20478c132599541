"""What the benchmark loads: never JAX or the JAX package (whose name the
port's begins with, so names are compared whole), and a reference that
imports nothing of the program; the run refuses to start without a card."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from amgbench import harness

HERE = pathlib.Path(__file__).resolve().parent
PKG = HERE.parent
ROOT = PKG.parent


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        found = imported_tops(path) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_numpy_and_scipy_only():
    allowed = {"__future__", "importlib", "itertools", "numpy", "scipy",
               "amgbench"}
    for path in (PKG / "reference").glob("*.py"):
        assert imported_tops(path) <= allowed, path
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("amgbench"):
                assert node.module.startswith("amgbench.reference"), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "raptor_tpu_torch_like", sys)
    assert "raptor_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "raptor_tpu.core", sys)
    assert harness.forbidden_modules() == ["raptor_tpu"]


SCRIPT = """
import json, sys
from amgbench import catalog, harness
bench = catalog.benchmark()
cfg = catalog.config(bench, "lap27-128")
cfg["grid"] = [8, 8, 8]
out = harness.execute(bench, "lap27-128.refine-f32", 3, 0.01, True,
                      "cpu", config=cfg)
ref = sorted(m for m in sys.modules if m.startswith("amgbench.reference"))
print(json.dumps({"correct": out["correct"],
                  "forbidden": harness.forbidden_modules(),
                  "port": "raptor_tpu_torch" in sys.modules, "ref": ref}))
"""


def test_a_run_loads_the_port_and_nothing_of_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "forbidden": [], "port": True,
                   "ref": got["ref"]}
    assert "amgbench.reference.laplace_27pt" in got["ref"]


def test_the_run_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run(
        [sys.executable, "-m", "amgbench.run", "--workload",
         "aniso2d-2048.refine-f32", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "{" not in res.stdout
    assert "CUDA" in res.stderr
