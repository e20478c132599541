"""Shared by the parity tests of the twins in ``examples_torch/``: run a
JAX script of ``examples/`` as it stands, in a subprocess on the CPU (the
conftest's 8 host devices), with the residual histories of its solves
recorded at full precision, and run a twin's ``main`` on the CPU with its
printed lines captured."""

import contextlib
import importlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

# run in the subprocess: record every solve of the JAX package (the
# device hierarchy's, the blocked one's, cg's and gmres's) as it returns,
# by patching each module right after it is first imported, so the
# script's own jax.config settings still come before any of its imports
_RECORDER = r"""
import importlib.abc, importlib.machinery, json, runpy, sys
import numpy as np

out_path, script = sys.argv[1], sys.argv[2]
sys.argv = [script] + sys.argv[3:]
records = []


def keep(fn, res, k):
    records.append({"fn": fn, "n_iters": int(k),
                    "res": [float(v) for v in np.asarray(res)[:int(k) + 1]]})


def patch_dh(mod):
    solve = mod.DeviceHierarchy.solve

    def wrapped(self, *a, **kw):
        r = solve(self, *a, **kw)
        keep("solve", r.res, r.n_iters)
        return r
    mod.DeviceHierarchy.solve = wrapped


def patch_bsr(mod):
    solve = mod.BSRDeviceHierarchy.solve

    def wrapped(self, *a, **kw):
        x, hist, k = solve(self, *a, **kw)
        keep("bsr_solve", hist, k)
        return x, hist, k
    mod.BSRDeviceHierarchy.solve = wrapped


def patch_fn(name):
    def patch(mod):
        fn = getattr(mod, name)

        def wrapped(*a, **kw):
            r = fn(*a, **kw)
            keep(name, r.res, r.n_iters)
            return r
        setattr(mod, name, wrapped)
    return patch


PATCHES = {"raptor_tpu.multilevel.device_hierarchy": patch_dh,
           "raptor_tpu.multilevel.bsr_hierarchy": patch_bsr,
           "raptor_tpu.krylov.cg": patch_fn("cg"),
           "raptor_tpu.krylov.gmres": patch_fn("gmres")}


class Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name not in PATCHES:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        run = spec.loader.exec_module

        def exec_module(mod):
            run(mod)
            PATCHES[name](mod)
        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, Finder())
try:
    runpy.run_path(script, run_name="__main__")
finally:
    with open(out_path, "w") as f:
        json.dump(records, f)
"""


def run_jax(script: str, *args, timeout: float = 300, x64: bool = False):
    """(stdout, records) of ``python examples/<script> *args`` on the CPU;
    each record {"fn", "n_iters", "res"} is one solve, in call order.
    ``x64``: JAX's 64-bit mode on from the start (JAX_ENABLE_X64), for a
    script that leaves it off."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    if x64:
        env["JAX_ENABLE_X64"] = "1"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "records.json")
        out = subprocess.run(
            [sys.executable, "-c", _RECORDER, rec,
             str(REPO / "examples" / script), *map(str, args)],
            cwd=REPO, env=env, capture_output=True, text=True,
            timeout=timeout)
        assert out.returncode == 0, out.stderr[-4000:]
        with open(rec) as f:
            return out.stdout, json.load(f)


def run_twin(name: str, *args):
    """(stdout, counts) of ``examples_torch.<name>.main([*args, "--device",
    "cpu"])``."""
    mod = importlib.import_module(f"examples_torch.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        counts = mod.main([*map(str, args), "--device", "cpu"])
    return buf.getvalue(), counts


TABLE_ROW = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s+[\d.]+\s*$")


def hierarchy(stdout: str):
    """The (level, rows, nnz) rows of ``print_hierarchy``'s table."""
    return [tuple(int(v) for v in m.groups())
            for m in map(TABLE_ROW.match, stdout.splitlines()) if m]


def grab(pattern: str, stdout: str, cast=int):
    """Every match of ``pattern``'s groups in ``stdout``, cast."""
    out = []
    for m in re.finditer(pattern, stdout, re.M):
        g = [cast(v) for v in m.groups()]
        out.append(g[0] if len(g) == 1 else tuple(g))
    return out


def same_history(got, want, rtol=1e-6):
    """Residual histories of the same length, equal to ``rtol``."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, (got, want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
