"""The traffic drivers and whole runs at a tiny size on the CPU, through
the port's plain versions: the program's answers pass the check, the
control's (one precision below) fail it, and so does a run whose timed
path is broken underneath."""

import json

import numpy as np
import pytest
import scipy.sparse.linalg as spla

from amgbench import catalog, harness
from amgbench.reference import assemble
from amgbench.reference.residual import relative_residual
from conftest import small_config

BENCH = catalog.benchmark()
SMALL = {"aniso2d-2048": (40, 40), "lap27-128": (12, 12, 12)}
CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2 ** 31 + 99


def grid_of(cell_name):
    return SMALL[catalog.cell(BENCH, cell_name)["config"]]


def set_up(cell_name):
    cell = catalog.cell(BENCH, cell_name)
    config = small_config(BENCH, cell_name, grid_of(cell_name))
    mix = catalog.traffic(cell["traffic"])
    from raptor_tpu_torch.core.par_matrix import par_matrix_from_scipy
    matrix = assemble(config)
    ml = catalog.setup(config["setup"]["solver"]).build(config["setup"],
                                                         "cpu")
    ml.setup(par_matrix_from_scipy(matrix.copy(), 1))
    pool = harness.make_pool(SEED, dict(mix, pool=3), matrix, "cpu")
    return matrix, ml, mix, pool


def worst(matrix, entry, pool):
    solves = [entry.solve(b) for b in pool]
    return solves, max(relative_residual(matrix, s.x, b)
                       for s, b in zip(solves, pool))


@pytest.mark.parametrize("cell_name", CELLS)
def test_entry_and_its_control(cell_name):
    matrix, ml, mix, pool = set_up(cell_name)
    module = catalog.entry(mix["entry"])
    solves, program = worst(matrix, module.prepare(ml, mix, "cpu"), pool)
    assert all(s.converged and 0 < s.steps <= mix["max_iter"]
               for s in solves)
    assert program <= mix["tol"]
    _, control = worst(matrix, module.prepare_control(ml, mix, "cpu"), pool)
    assert control > 3 * mix["tol"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_pool_is_the_image_of_the_seeds_solutions(cell_name, monkeypatch):
    config = small_config(BENCH, cell_name, grid_of(cell_name))
    mix = dict(catalog.traffic(catalog.cell(BENCH, cell_name)["traffic"]),
               pool=4)
    matrix = assemble(config)
    # two values a device call: the pool is drawn in two calls
    monkeypatch.setattr(harness, "POOL_CHUNK", 2 * matrix.shape[0])
    a = harness.make_pool(SEED, mix, matrix, "cpu")
    assert a.shape == (4, matrix.shape[0]) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, harness.make_pool(SEED, mix, matrix,
                                                       "cpu"))
    assert not np.array_equal(a, harness.make_pool(SEED + 1, mix, matrix,
                                                   "cpu"))
    assert len({row.tobytes() for row in a}) == 4
    # each b is A x for an x within a few x_noise of x_base
    x = np.stack([spla.spsolve(matrix.tocsc(), b) for b in a])
    assert np.abs(x - mix["x_base"]).max() < 6 * mix["x_noise"]
    assert x.std() > mix["x_noise"] / 2


def test_sample_is_drawn_from_the_seed():
    def kept(seed, n):
        s = harness.Sample(seed, 3)
        for i in range(n):
            s.offer(i)
        return s.kept
    assert kept(5, 2) == [0, 1]
    assert kept(5, 50) == kept(5, 50)
    assert len(set(kept(5, 50))) == 3
    assert any(kept(s, 50) != kept(5, 50) for s in range(6, 12))


def run(cell_name, trace_on=False, seconds=0.01):
    config = small_config(BENCH, cell_name, grid_of(cell_name))
    return harness.execute(BENCH, cell_name, SEED, seconds, trace_on, "cpu",
                           config=config)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_run_on_the_cpu(cell_name):
    out = run(cell_name)
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["end_to_end"]) == {"setup_s", "solve_ms"}
    assert list(out["checks"]) == ["max_relres", "unconverged"]
    traced = run(cell_name, trace_on=True)
    # the card's probes read nothing here: only the spans and the counts
    assert set(traced["per_layer"]) == {"amg_setup_s", "pack_s",
                                        "refinements_per_solve"}
    assert "busy_s" not in traced


def _unchanged_state(monkeypatch):
    from raptor_tpu_torch.multilevel import device_hierarchy
    monkeypatch.setattr(device_hierarchy.DeviceHierarchy, "vcycle",
                        lambda self, x, b, level=0: x)


def _half_left_out(monkeypatch):
    from raptor_tpu_torch.device import par
    host_vector = par.host_vector

    def half(x, bounds, first_shard=0):
        v = host_vector(x, bounds, first_shard)
        v[len(v) // 2:] = 0.0
        return v
    monkeypatch.setattr(par, "host_vector", half)


def _answer_altered(monkeypatch):
    from raptor_tpu_torch.device import par
    host_vector = par.host_vector
    monkeypatch.setattr(par, "host_vector",
                        lambda x, bounds, first_shard=0:
                        host_vector(x, bounds, first_shard) * (1 + 1e-6))


@pytest.mark.parametrize("fault", [_unchanged_state, _half_left_out,
                                   _answer_altered])
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    fault(monkeypatch)
    out = run(cell_name)
    assert out["correct"] is False
    assert out["checks"]["max_relres"]["value"] > \
        out["checks"]["max_relres"]["limit"] or out["failed"] > 0


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_in_the_timed_path_is_not_correct(cell_name,
                                                      monkeypatch):
    """The control (the entry one precision below) put in the program's
    place under a whole run: the run's own check reads it as not correct."""
    mix = catalog.traffic(catalog.cell(BENCH, cell_name)["traffic"])
    module = catalog.entry(mix["entry"])
    monkeypatch.setattr(module, "prepare", module.prepare_control)
    out = run(cell_name)
    assert out["correct"] is False
    relres = out["checks"]["max_relres"]
    assert relres["value"] > relres["limit"]


def test_calibrate_reads_the_program_below_and_the_control_above(capsys):
    from amgbench import calibrate
    assert calibrate.main(["--config", "lap27-128", "--traffic",
                           "refine-f32", "--seeds", "11", "12",
                           "--control-seeds", "13", "--device", "cpu",
                           "--grid", "8", "8", "8"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [d["side"] for d in lines[:3]] == [
        "refine-f32:program", "refine-f32:program", "refine-f32:control"]
    summary = lines[-1]
    assert summary["lower"] <= summary["limit"] < summary["upper"]
