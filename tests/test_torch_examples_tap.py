"""Parity of the exchange twins in ``examples_torch/`` (SpMV plain and
TAP, the TAP AMG sweep, the comm model, ``profile_amg``'s TAP flag) with
the JAX package's scripts in ``examples/``, run as
``test_torch_examples_basic.py`` runs them: formats, comm-model counts
and iteration counts equal. Times are not compared."""

import pytest

pytest.importorskip("torch")

from _torch_examples import grab, hierarchy, run_jax, run_twin, same_history
from _torch_parity import _one_intra_op_thread  # noqa: F401


def comm_lines(stdout):
    """The comm model's lines (messages and bytes by class, maxima,
    locality, TAP steps)."""
    keep = ("  short", "  eager", "  rendezvous", "  max per", "  intra-host",
            "  step ", "comm model", "TAP dedup", "DCN bytes")
    return [l for l in stdout.splitlines() if l.startswith(keep)]


@pytest.mark.parametrize("args", [(12,), (16,)])
def test_benchmark_spmv(args):
    """The 27-point SpMV on 8 shards: its format and the comm model's
    every count equal."""
    out, _ = run_jax("benchmark_spmv.py", *args)
    tout, got = run_twin("benchmark_spmv", *args)
    assert grab(r"^plain SpMV \((\w+)\)", out, str) == [got["format"]]
    assert comm_lines(tout) == comm_lines(out) and len(comm_lines(out)) > 5


@pytest.mark.parametrize("args", [(32, 2, 4), (48, 4, 2)])
def test_benchmark_tap_spmv(args):
    """Plain against TAP on a (host, local) layout: the mesh, nnz and
    format line and the inter-host bytes of both schedules equal; TAP's
    product equal to the plain one."""
    out, _ = run_jax("benchmark_tap_spmv.py", *args)
    tout, got = run_twin("benchmark_tap_spmv", *args)
    head = grab(r"^(\d+x\d+ mesh, .*)$", out, str)
    assert grab(r"^(\d+x\d+ mesh, .*)$", tout, str) == head
    dcn = grab(r"^DCN bytes/exchange: plain (\d+) vs TAP (\d+)", out)
    assert dcn == [(got["plain_inter_host_bytes"],
                    got["tap_inter_host_bytes"])]
    assert got["tap_max_abs_diff"] <= 1e-6


def test_benchmark_tap_amg():
    """HMIS + extended+i + SOR in float32 to 1e-6, plain and TAP from
    every level: the hierarchy and every solve's V-cycles equal."""
    args = (32, 2)
    out, rec = run_jax("benchmark_tap_amg.py", *args)
    tout, got = run_twin("benchmark_tap_amg", *args)
    assert hierarchy(tout) == hierarchy(out)
    pat = r"^(plain|tap>=\d+) +\d+x\d+: (\d+) V-cycles"
    runs = grab(pat, out, str)
    assert grab(pat, tout, str) == runs
    assert len(runs) == len(hierarchy(out)) + 1
    assert [int(r[1]) for r in runs] == [got["plain"]] + [
        got["tap"][k] for k in sorted(got["tap"], reverse=True)]


@pytest.mark.parametrize("args", [(32, 2, 4), (64, 4, 2), (48, 2, 2)])
def test_model_tap_steps(args):
    """Plain and TAP schedules: every line of the comm model equal (each
    class's messages and bytes, the maxima, the locality split, each TAP
    step, the bytes saved)."""
    out, _ = run_jax("model_tap_steps.py", *args)
    tout, got = run_twin("model_tap_steps", *args)
    lines = [l for l in tout.splitlines()
             if not l.startswith("kernel launches: ")]
    assert lines == out.splitlines()
    assert got["saved"] == (got["plain"]["inter_host_bytes"]
                            - got["tap"]["inter_host_bytes"])


def test_profile_amg():
    """HMIS + extended+i + SOR in float32 to 1e-6 with the setup split and
    the per-level table, then TAP on every level (2 x 4): the hierarchy,
    the setup table's shape, both solves' V-cycles and the per-level
    table's levels equal."""
    args = (32, "HMIS", "Extended", 1)
    out, rec = run_jax("profile_amg.py", *args)
    tout, got = run_twin("profile_amg", *args)
    assert hierarchy(tout) == hierarchy(out)
    assert grab(r"^solve: (\d+) V-cycles", out) == [got["iterations"]]
    assert grab(r"^TAP 2x4 mesh: (\d+) V-cycles", out) == [
        got["tap_iterations"]]
    table = r"^\s*(\d+)(?:\s+\d+\.\d+){3}\s*$"
    assert grab(table, tout) == grab(table, out)
    assert got["iterations"] == rec[1]["n_iters"]
