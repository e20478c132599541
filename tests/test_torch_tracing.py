"""The port's spans and counters (``profiling.timers``: ``span``,
``count``, ``recording``, ``take``) on the CPU: what a solve records,
that the spans nest and lie in a ``torch.profiler`` trace, the packing's
phases (``DeviceHierarchy.pack_times``) and that the setup timers keep
their keys and values. Imports no JAX. The card's case, launches inside
the cycle's spans, is in tests/test_torch_tracing_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402

from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils  # noqa: E402
from raptor_tpu_torch.krylov.cg import cg  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.profiling import timers  # noqa: E402
from raptor_tpu_torch.profiling.timers import (  # noqa: E402
    Profiler, count, device_trace, recording, span, take)

RS_PHASES = {"strength", "cf_splitting", "interpolation", "RAP"}


@pytest.fixture(autouse=True)
def _one_thread_and_nothing_recorded():
    """One intra-op thread for these small shapes, and a recorder that
    starts and ends empty."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    take()
    yield
    take()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    A = stencils.par_stencil_grid(
        stencils.diffusion_stencil_2d(0.001, np.pi / 8), (32, 32), 2)
    with recording():
        ml = ParRugeStubenSolver(0.25, CoarsenType.RS,
                                 InterpType.ModClassical,
                                 relax_type=RelaxType.Chebyshev)
        ml.num_smooth_sweeps = 2
        ml.rap_mode = ml.interp_mode = "host"
        ml.setup(A)
    return A, ml, take()


@pytest.fixture(scope="module")
def dh(setup):
    _, ml, _ = setup
    return DeviceHierarchy(ml, dtype=torch.float32, device="cpu")


def rhs(A, seed=0):
    return A.mult(np.random.default_rng(seed).standard_normal(
        A.global_num_rows))


def encloses(outer, inner):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_off_is_one_shared_no_op():
    assert not autograd_profiler._is_profiler_enabled
    a, b = span("raptor.a"), span("raptor.b")
    assert a is b is timers._OFF
    assert timers.solve_span("raptor.c") is a
    with a:
        count("syncs")
    assert take() == ([], {})


def test_a_solve_with_recording_off_records_nothing(setup, dh):
    A = setup[0]
    x, hist = dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A), tol=1e-8)
    assert len(hist) > 2 and hist[-1] <= 1e-8
    assert take() == ([], {})


def test_a_recorded_solve_counts_its_syncs_cycles_and_solve(setup, dh):
    A = setup[0]
    with recording():
        x, hist = dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A),
                                 tol=1e-8)
    spans, counters = take()
    # the norm of b, one a residual, the solution's read back
    assert counters == {"solves": 1, "syncs": len(hist) + 2,
                        "cycles": len(hist) - 1}
    names = [s.name for s in spans]
    assert names[0] == "raptor.solve_mixed" and spans[0].parent is None
    assert names.count("raptor.put") == 2
    assert names.count("raptor.host") == 1
    assert names.count("raptor.sync") == len(hist) + 1
    assert names.count("raptor.refine.residual") == len(hist)
    assert names.count("raptor.vcycle.L0") == len(hist) - 1
    last = len(dh.levels) - 1
    assert names.count(f"raptor.vcycle.L{last}") == len(hist) - 1
    assert names.count("raptor.coarse_solve") == len(hist) - 1
    for step in ("raptor.relax.pre", "raptor.residual", "raptor.restrict",
                 "raptor.prolong", "raptor.relax.post"):
        assert names.count(step) == last * (len(hist) - 1), step


def test_every_span_lies_inside_its_parent_and_its_solve(setup, dh):
    A = setup[0]
    with recording():
        for seed in (1, 2):
            dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A, seed),
                           tol=1e-6)
    spans, counters = take()
    assert counters["solves"] == 2
    solves = [s for s in spans if s.name == "raptor.solve_mixed"]
    assert len(solves) == 2 and solves[0].solve_id != solves[1].solve_id
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert s.solve_id in (solves[0].solve_id, solves[1].solve_id)
        if s.parent is not None:
            parent = spans[s.parent]
            assert encloses(parent, s), (parent.name, s.name)
            assert parent.solve_id == s.solve_id
    # a level's steps are children of its cycle span, and the next level's
    # cycle a child of the level above
    for s in spans:
        if s.name.startswith("raptor.relax."):
            assert spans[s.parent].name.startswith("raptor.vcycle.L")
        if s.name == "raptor.vcycle.L1":
            assert spans[s.parent].name == "raptor.vcycle.L0"


def test_recording_nests_and_counts_only_inside():
    count("outside")
    with recording():
        with recording():
            count("inner", 2)
        count("outer")
        with span("raptor.x"):
            pass
    count("outside")
    spans, counters = take()
    assert counters == {"inner": 2, "outer": 1}
    assert [s.name for s in spans] == ["raptor.x"]
    assert spans[0].solve_id is None


def test_the_profiler_flag_turns_spans_on():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled
        assert span("raptor.on") is not timers._OFF
    assert not autograd_profiler._is_profiler_enabled
    assert span("raptor.on") is timers._OFF


def test_spans_lie_in_a_cpu_profile_and_nest_there(setup, dh):
    from torch.profiler import ProfilerActivity, profile
    A = setup[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A), tol=1e-6)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("raptor.")]
    by_name = {}
    for e in events:
        by_name.setdefault(e.name(), []).append(e)
    solve = by_name["raptor.solve_mixed"]
    assert len(solve) == 1
    lo, hi = solve[0].start_ns(), solve[0].end_ns()
    assert all(lo <= e.start_ns() <= e.end_ns() <= hi for e in events)
    cycles = by_name["raptor.vcycle.L0"]
    assert cycles and len(by_name["raptor.vcycle.L1"]) == len(cycles)
    for inner in by_name["raptor.vcycle.L1"]:
        assert any(c.start_ns() <= inner.start_ns()
                   and inner.end_ns() <= c.end_ns() for c in cycles)
    assert len(by_name["raptor.sync"]) >= len(cycles) + 1
    # the profiler alone records them in memory too
    spans, counters = take()
    assert [s.name for s in spans].count("raptor.vcycle.L0") == len(cycles)
    assert counters["cycles"] == len(cycles)


def test_device_trace_records_the_spans(setup, dh, tmp_path):
    import json
    A = setup[0]
    b = dh.vector(rhs(A))
    with device_trace(str(tmp_path)) as path:
        dh.vcycle(torch.zeros_like(b), b)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"raptor.vcycle.L0", "raptor.relax.pre",
            "raptor.coarse_solve"} <= names
    spans, counters = take()
    assert spans[0].name == "raptor.vcycle.L0" and counters == {"cycles": 1}


def test_solve_and_cg_record_their_reads(setup, dh):
    A = setup[0]
    b = dh.vector(rhs(A))
    with recording():
        out = dh.solve(torch.zeros_like(b), b)
    spans, counters = take()
    assert spans[0].name == "raptor.solve"
    # the norm of b, then one a residual
    assert counters == {"solves": 1, "syncs": out.n_iters + 2,
                        "cycles": out.n_iters}
    with recording():
        res = cg(dh.levels[0].A, torch.zeros_like(b), b, tol=1e-5,
                 precond=dh.precond_pack())
    spans, counters = take()
    assert spans[0].name == "raptor.cg"
    assert counters == {"solves": 1, "syncs": res.n_iters + 1,
                        "cycles": res.n_iters + 1}
    iters = [s for s in spans if s.name == "raptor.cg.iter"]
    assert len(iters) == res.n_iters
    for s in spans:
        if s.name == "raptor.vcycle.L0" and s.parent is not None:
            assert spans[s.parent].name in ("raptor.cg", "raptor.cg.iter")


def test_pack_times_split_the_packing_by_phase_and_level(setup, dh):
    _, ml, _ = setup
    times = dh.pack_times.times
    assert {"format", "relax", "copy", "coarse_lu"} <= set(times)
    assert all(v > 0.0 for v in times.values())
    # the copies nest inside format and relax and are left out of their own
    assert dh.pack_times.nested["format"] + dh.pack_times.nested["relax"] \
        == pytest.approx(times["copy"])
    assert 0.0 < dh.pack_times.own("format") < times["format"]
    assert 0.0 < dh.pack_times.own("relax") < times["relax"]
    assert len(dh.pack_level_times) == len(dh.levels) == ml.num_levels
    for split in dh.pack_level_times:
        assert {"format", "relax", "copy"} <= set(split)
    assert "coarse_lu" in dh.pack_level_times[-1]
    for k, v in times.items():
        assert sum(d.get(k, 0.0) for d in dh.pack_level_times) \
            == pytest.approx(v)


def test_the_float64_fine_operator_is_packed_under_level_0(setup):
    A, ml, _ = setup
    dh = DeviceHierarchy(ml, dtype=torch.float32, device="cpu")
    before = dict(dh.pack_level_times[0])
    count_before = dh.pack_times.counts["format"]
    dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A), tol=1e-4)
    dh.solve_mixed(np.zeros(A.global_num_rows), rhs(A), tol=1e-4)
    assert dh.pack_times.counts["format"] == count_before + 1
    assert dh.pack_level_times[0]["format"] > before["format"]
    assert dh.pack_level_times[0]["copy"] > before["copy"]


def test_setup_times_keep_their_keys_and_values(setup):
    _, ml, recorded = setup
    assert set(ml.setup_times.times) == RS_PHASES
    assert len(ml.setup_level_times) == ml.num_levels - 1
    for k, v in ml.setup_times.times.items():
        assert sum(d.get(k, 0.0) for d in ml.setup_level_times) \
            == pytest.approx(v)
    # each phase is also a span, named with the setup's prefix
    names = [s.name for s in recorded.spans]
    for k in RS_PHASES:
        assert names.count(f"raptor.setup.{k}") == ml.setup_times.counts[k]


def test_profiler_nesting_own_time_and_tally():
    p, q = Profiler("raptor.t."), Profiler()
    with recording():
        with p.phase("outer"):
            with timers.nested_phase("inner"):
                pass
            with q.phase("other"):
                with timers.nested_phase("inner"):
                    pass
        with timers.nested_phase("alone"):
            pass
        p.tally("builds", 3)
    spans, counters = take()
    assert set(p.times) == {"outer", "inner"} and p.counts["inner"] == 1
    assert set(q.times) == {"other", "inner"}
    assert p.nested["outer"] == pytest.approx(p.times["inner"])
    assert p.own("outer") == pytest.approx(p.times["outer"]
                                           - p.times["inner"])
    assert p.own("absent") == 0.0
    assert p.counts["builds"] == 3 and counters == {"builds": 3}
    assert [s.name for s in spans] == [
        "raptor.t.outer", "raptor.t.inner", "raptor.other", "raptor.inner",
        "raptor.alone"]
    assert spans[1].parent == 0 and spans[3].parent == 2
    # the tally counts while recording is off too; the counter does not
    p.tally("builds")
    assert p.counts["builds"] == 4 and take().counters == {}


def test_take_returns_an_open_span_unfinished_and_keeps_its_place():
    with recording():
        with span("raptor.open"):
            with span("raptor.done"):
                pass
            first = take()
            with span("raptor.after"):
                pass
    assert [s.name for s in first.spans] == ["raptor.open", "raptor.done"]
    assert first.spans[0].end_ns is None and first.spans[1].parent == 0
    # the parent was taken before: the later span names none
    assert [(s.name, s.parent) for s in take().spans] == [
        ("raptor.after", None)]
