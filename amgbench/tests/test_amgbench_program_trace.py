"""The reductions of the program's spans and counters
(``program_trace``) on synthetic spans and launches, and the readers of
the eight metrics that read them, which give None off the card and for a
program that keeps no spans."""

import types

import pytest

from amgbench import program_trace as pt

MS = 1_000_000      # ns


def spans():
    """Two solves of one refinement each; the first cycle's level 1 lies
    inside its level 0. (name, start, end, parent, solve_id), in ns."""
    return [
        ("raptor.solve_mixed", 0, 100 * MS, None, 1),                 # 0
        ("raptor.put", 0, 2 * MS, 0, 1),                              # 1
        ("raptor.put", 2 * MS, 4 * MS, 0, 1),                         # 2
        ("raptor.sync", 4 * MS, 5 * MS, 0, 1),                        # 3
        ("raptor.refine.residual", 5 * MS, 6 * MS, 0, 1),             # 4
        ("raptor.sync", 6 * MS, 7 * MS, 0, 1),                        # 5
        ("raptor.vcycle.L0", 10 * MS, 40 * MS, 0, 1),                 # 6
        ("raptor.vcycle.L1", 20 * MS, 30 * MS, 6, 1),                 # 7
        ("raptor.refine.residual", 40 * MS, 41 * MS, 0, 1),           # 8
        ("raptor.sync", 41 * MS, 61 * MS, 0, 1),                      # 9
        ("raptor.host", 90 * MS, 100 * MS, 0, 1),                     # 10
        ("raptor.solve_mixed", 200 * MS, 260 * MS, None, 2),          # 11
        ("raptor.vcycle.L0", 210 * MS, 230 * MS, 11, 2),              # 12
        ("raptor.sync", 230 * MS, 240 * MS, 11, 2),                   # 13
    ]


def test_span_table_totals_self_times_and_counts():
    table = pt.span_table(spans())
    assert table["raptor.vcycle.L0"] == pytest.approx([0.050, 0.040, 2])
    assert table["raptor.vcycle.L1"] == pytest.approx([0.010, 0.010, 1])
    # the first solve less its eleven children (2+2+1+1+1+30+1+20+10 ms)
    # and the second less its two
    assert table["raptor.solve_mixed"] == pytest.approx(
        [0.160, 0.100 - 0.068 + 0.060 - 0.030, 2])
    assert table["raptor.sync"][2] == 4


def test_solve_split_reads_the_counters_and_the_spans_per_solve():
    split = pt.solve_split(spans(), {"solves": 2, "syncs": 9, "cycles": 2})
    assert split["host_syncs_per_solve"] == 4.5
    assert split["solve_wait_ms"] == pytest.approx((1 + 1 + 20 + 10) / 2)
    assert split["solve_io_ms"] == pytest.approx((2 + 2 + 10) / 2)
    assert split["residual_ms"] == pytest.approx(1.0)
    assert split["solve_span_ms"] == pytest.approx(80.0)
    assert split["cycles_per_solve"] == 1.0
    assert split["cycle_host_ms"] == pytest.approx(25.0)


def test_cycles_inside_cycles_and_outside_solves():
    s = spans()
    # a level-0 cycle inside another (a cycle of a cycle) counts once, and
    # one outside any solve does not count
    s.append(("raptor.vcycle.L0", 22 * MS, 24 * MS, 7, 1))
    s.append(("raptor.vcycle.L0", 300 * MS, 400 * MS, None, None))
    split = pt.solve_split(s, {"solves": 2, "syncs": 9})
    assert split["cycles_per_solve"] == 1.0
    assert split["cycle_host_ms"] == pytest.approx(25.0)
    assert [x[1] for x in pt.outermost(s, "raptor.vcycle.L0")] == [
        10 * MS, 210 * MS, 300 * MS]


def test_a_probe_with_nothing_recorded_reads_nothing():
    assert pt.solve_split([], {}) is None
    split = pt.solve_split([("raptor.solve_mixed", 0, MS, None, 1)],
                           {"solves": 1, "syncs": 3})
    assert split["cycle_host_ms"] is None and split["cycles_per_solve"] == 0
    assert split["host_syncs_per_solve"] == 3


def test_launches_inside_and_outside_level_0_cycles():
    cycles = [(10, 20), (30, 40)]
    launches = [5, 10, 11, 19.5, 20, 25, 31, 39, 41]
    # 10, 11, 19.5, 20 in the first; 31, 39 in the second
    assert pt.launches_per_cycle(cycles, launches) == 3.0
    assert pt.launches_per_cycle(cycles, []) == 0.0


def test_launches_of_nested_cycles_count_once():
    cycles = [(10, 40), (15, 20), (50, 60)]
    launches = [12, 16, 17, 30, 55]
    assert pt.launches_per_cycle(cycles, launches) == 2.5


def test_launches_without_cycles_read_nothing():
    assert pt.launches_per_cycle([], [1, 2, 3]) is None


def test_the_launch_calls_matched():
    for name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernel", "cuLaunchKernelEx"):
        assert pt.LAUNCH.match(name)
    for name in ("cudaMemcpyAsync", "aten::add", "cudaStreamSynchronize"):
        assert not pt.LAUNCH.match(name)


def _ctx(on_card, dh):
    return types.SimpleNamespace(on_card=on_card,
                                 entry=types.SimpleNamespace(dh=dh))


def test_readers_give_none_off_the_card_and_without_timers():
    from amgbench import catalog
    from raptor_tpu_torch.profiling.timers import Profiler
    times = Profiler("raptor.pack.")
    with times.phase("format"):
        with times.phase("copy"):
            pass
    with_timers = types.SimpleNamespace(pack_times=times)
    for name in ("host_syncs_per_solve", "solve_wait_ms", "solve_io_ms",
                 "cycle_host_ms", "launches_per_cycle", "pack_format_s",
                 "pack_relax_s", "pack_copy_s"):
        read = catalog.reader(name)
        assert read(_ctx(False, with_timers)) is None, name
        # a port that keeps no pack timers, read on the card, reads nothing
        if name.startswith("pack_"):
            assert read(_ctx(True, types.SimpleNamespace())) is None
    ctx = _ctx(True, with_timers)
    assert catalog.reader("pack_format_s")(ctx) == pytest.approx(
        times.times["format"] - times.times["copy"])
    assert catalog.reader("pack_copy_s")(ctx) == times.times["copy"]
    assert catalog.reader("pack_relax_s")(ctx) is None
