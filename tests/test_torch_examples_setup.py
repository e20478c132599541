"""Parity of the setup twins in ``examples_torch/`` (the per-component
RS setup, the Galerkin products, the SA prolongation sweep, the setup
over processes, the per-level comm profile) with the JAX package's
scripts in ``examples/``, run as ``test_torch_examples_basic.py`` runs
them: rows, nnz, iteration and comm-model counts equal, float64
histories equal to rtol 1e-6. Times are not compared."""

import pytest

pytest.importorskip("torch")

from _torch_examples import grab, run_jax, run_twin, same_history
from _torch_parity import _one_intra_op_thread  # noqa: F401

LEVEL_ROW = r"^\s*(\d+)\s+(\d+)\s+(\d+)$"


@pytest.mark.parametrize("args", [(64, "CLJP", "ModClassical"),
                                  (48, "PMIS", "Extended"),
                                  (40, "HMIS", "Direct"),
                                  (40, "Falgout", "ModClassical")])
def test_benchmark_setup(args):
    """The stages level by level: every level's rows and nnz equal, the
    four phase timers each counted once a level."""
    out, _ = run_jax("benchmark_setup.py", *args)
    tout, got = run_twin("benchmark_setup", *args)
    rows = grab(LEVEL_ROW, out)
    assert grab(LEVEL_ROW, tout) == rows and len(rows) > 2
    assert [tuple(r) for r in got["levels"]] == [r[1:] for r in rows]
    timers = grab(r"^  (\w+)\s+\S+s  x(\d+)$", out, str)
    assert grab(r"^  (\w+)\s+\S+s  x(\d+)$", tout, str) == timers
    assert {t[1] for t in timers} == {str(len(rows))}


@pytest.mark.parametrize("args", [(64,), (48, "PMIS", "Extended"),
                                  (40, "CLJP", "Direct")])
def test_benchmark_spgemm(args):
    """Each level's Galerkin output nnz (nnz(AP) + nnz(Ac)) equal."""
    out, _ = run_jax("benchmark_spgemm.py", *args)
    tout, got = run_twin("benchmark_spgemm", *args)
    rows = grab(r"^\s*(\d+)\s+(\d+)\s+\S+\s+\S+$", out)
    assert grab(r"^\s*(\d+)\s+(\d+)\s+\S+\s+\S+$", tout) == rows
    assert got["rap_nnz"] == [r[1] for r in rows] and len(rows) > 2
    assert set(got["rap_engines"]) == {"host"}


def test_benchmark_setup_sweeps():
    """SA with 0-3 prolongation steps: each one's levels, operator
    complexity and float64 V-cycles, flat and TAP, equal; every history
    to 1e-6."""
    args = (24, 2, 2)
    out, rec = run_jax("benchmark_setup_sweeps.py", *args)
    tout, got = run_twin("benchmark_setup_sweeps", *args)
    shape = grab(r", (\d+) levels, op complexity (\S+)$", out, str)
    assert grab(r", (\d+) levels, op complexity (\S+)$", tout, str) == shape
    iters = grab(r"^  (\w+) *: +(\d+) iters", out, str)
    assert grab(r"^  (\w+) *: +(\d+) iters", tout, str) == iters
    warm = rec[1::2]                # each solve twice: compile, then timed
    assert len(warm) == len(iters) == 8
    for row, (flat, tap) in zip(got["sweeps"], zip(warm[::2], warm[1::2])):
        assert row["flat"] == flat["n_iters"] and row["TAP"] == tap["n_iters"]
        same_history(row["flat_residuals"], flat["res"])
        same_history(row["TAP_residuals"], tap["res"])


@pytest.mark.parametrize("args", [(24, 4), (20, 3)])
def test_run_multiproc_setup(args):
    """HMIS + extended+i + RAP over forked ranks: every rank's A, P and Ac
    block nnz and its coarse count equal."""
    out, _ = run_jax("run_multiproc_setup.py", *args)
    tout, got = run_twin("run_multiproc_setup", *args)
    pat = (r"rank (\d+): A block (\d+) nnz -> P block (\d+) nnz -> Ac block "
           r"(\d+) nnz \(n_coarse (\d+)\)")
    ranks = grab(pat, out)
    assert grab(pat, tout) == ranks == [tuple(r) for r in got["ranks"]]
    assert len(ranks) == args[1]


@pytest.mark.parametrize("args", [(32, 8, 2), (40, 4, 4)])
def test_profile_comm_levels(args):
    """Each level's rows, nnz, messages, inter-host and total bytes of the
    comm model equal (the SpMV time is the device's)."""
    out, _ = run_jax("profile_comm_levels.py", *args)
    tout, got = run_twin("profile_comm_levels", *args)
    pat = r"^\s*(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+\S+$"
    rows = grab(pat, out)
    assert grab(pat, tout) == rows and len(rows) > 2
    assert [tuple(r) for r in got["levels"]] == [r[1:] for r in rows]
