"""The program's own spans and counters over whole solves, and their
reductions.

``probe`` runs, once a run and on the card only, two solves of the cell's
entry under the program's ``recording()`` (``raptor_tpu_torch.profiling.
timers``), which give the times and the counts, then two under
``torch.profiler`` (host and card), which give the launches a cycle makes
and the card's idle time by the program's innermost span. It prints both
tables on standard error. A program without the spans (an older port)
gives None, and so does a run off the card.

The reductions take plain spans: ``(name, start, end, parent, solve_id)``
tuples whose ``parent`` is the index of the enclosing span, or None.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import time

from amgbench import trace

SOLVE = "raptor.solve_mixed"
CYCLE0 = "raptor.vcycle.L0"     # a whole V-cycle: its level-0 span
SYNC = "raptor.sync"            # the host blocked on a read of the card
IO = ("raptor.put", "raptor.host")
RESIDUAL = "raptor.refine.residual"
LAUNCH = re.compile(r"^cu(da)?LaunchKernel")   # cudaLaunch..., cuLaunch...
PREFIX = "raptor."
COUNT = 2                       # solves of each half of the probe
TOP = 24                        # rows of the span table


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def span_table(spans) -> dict:
    """For each name: ``[total, self, count]``, the seconds of its spans,
    the same less their direct children, and how many there are."""
    out = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for name, start, end, parent, _ in spans:
        row = out[name]
        row[0] += (end - start) / 1e9
        row[1] += (end - start) / 1e9
        row[2] += 1
        if parent is not None:
            p = spans[parent]
            out[p[0]][1] -= (end - start) / 1e9
    return dict(out)


def outermost(spans, name: str) -> list:
    """The spans called ``name`` that lie in no other of that name."""
    def inside(i):
        p = spans[i][3]
        while p is not None:
            if spans[p][0] == name:
                return True
            p = spans[p][3]
        return False
    return [s for i, s in enumerate(spans) if s[0] == name and not inside(i)]


def solve_split(spans, counters: dict) -> dict:
    """Per solve, in ms: the host blocked on the card (``SYNC``), the host
    vectors' copies (``IO``), the float64 residuals; the cycles' mean host
    ms (outermost level-0 spans inside a solve) and their count; the
    blocking reads a solve makes by the counters. None where nothing was
    recorded."""
    solves = counters.get("solves", 0)
    if not solves:
        return None
    table = span_table(spans)

    def per_solve(*names):
        return sum(table[n][0] for n in names if n in table) * 1e3 / solves
    cycles = [s for s in outermost(spans, CYCLE0) if s[4] is not None]
    return {
        "host_syncs_per_solve": counters.get("syncs", 0) / solves,
        "solve_wait_ms": per_solve(SYNC),
        "solve_io_ms": per_solve(*IO),
        "residual_ms": per_solve(RESIDUAL),
        "solve_span_ms": per_solve(SOLVE),
        "cycles_per_solve": len(cycles) / solves,
        "cycle_host_ms": (sum(e - s for _, s, e, _, _ in cycles) / 1e6
                          / len(cycles)) if cycles else None}


def launches_per_cycle(cycles, launches):
    """Launch calls (their host start times) that fall inside the cycles'
    ``(start, end)`` intervals, over the number of outermost cycles; a
    cycle inside another counts once, with its launches. None without
    cycles."""
    merged = trace.union(cycles, float("-inf"), float("inf"))
    if not merged:
        return None
    outer = 0
    reach = float("-inf")
    for s, e in sorted(cycles):
        if s >= reach:
            outer += 1
        reach = max(reach, e)
    starts = sorted(launches)
    inside = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(
        starts, s) for s, e in merged)
    return inside / outer


def _profiled(entry, pool):
    """``COUNT`` solves under ``torch.profiler``: the level-0 cycle spans
    and launch calls of the solving thread, the card's activity, the
    program's host spans, and the window from the first solve's start to
    the last one's end, all in microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(COUNT):
            entry.solve(pool[i])
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    solves = [e for e in events if e.name() == SOLVE
              and e.device_type() == DeviceType.CPU]
    if not solves:
        return None
    thread = solves[0].start_thread_id()
    cycles, launches, device, host = [], [], [], []
    # most events are the host's operators: read as little of each
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), e.start_ns() / 1e3,
                               e.end_ns() / 1e3))
            continue
        name = e.name()
        launch = LAUNCH.match(name)
        if not (launch or name.startswith(PREFIX)) or \
                e.start_thread_id() != thread:
            continue
        if launch:
            launches.append(e.start_ns() / 1e3)
            continue
        iv = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
        host.append(iv)
        if name == CYCLE0:
            cycles.append(iv[1:])
    window = (min(e.start_ns() for e in solves) / 1e3,
              max(e.end_ns() for e in solves) / 1e3)
    return cycles, launches, device, host, window


def _print_tables(recorded, split, idle, builds) -> None:
    solves = recorded.counters.get("solves", 1)
    log(f"program spans over {solves} recorded solves (ms a solve: total, "
        f"self; count a solve); counters {recorded.counters}")
    table = span_table(recorded.spans)
    for name, (tot, own, n) in sorted(table.items(),
                                      key=lambda kv: -kv[1][0])[:TOP]:
        log(f"  {name:28s} {tot * 1e3 / solves:10.3f} "
            f"{own * 1e3 / solves:10.3f} {n / solves:9.1f}")
    log("solve split (ms a solve): " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items() if v is not None))
    if idle is not None:
        log(f"card idle in the profiled solves by innermost program span: "
            f"busy {idle['busy_s']:.4f} s of {idle['window_s']:.4f} s")
        for name, sec in idle["idle_gaps"]:
            log(f"  {name:40s} {sec:.4f} s")
    log(f"native builds in this process: seconds {dict(builds.times)}, "
        f"counts {dict(builds.counts)}")


def _probe(ctx):
    if not ctx.on_card:
        return None
    try:
        from raptor_tpu_torch.profiling.timers import BUILDS, recording, take
    except ImportError:
        return None
    import torch

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    take()
    with recording():
        for i in range(COUNT):
            ctx.entry.solve(ctx.pool[i])
    recorded = take()
    split = solve_split(recorded.spans, recorded.counters)
    if split is None:
        return None
    prof = _profiled(ctx.entry, ctx.pool)
    take()                  # the profiled solves' spans, read from the trace
    idle = None
    if prof is not None:
        cycles, launches, device, host, window = prof
        split["launches_per_cycle"] = launches_per_cycle(cycles, launches)
        idle = trace.summarize(window, device, host)
    _print_tables(recorded, split, idle, BUILDS)
    log(f"program probe: {time.perf_counter() - t0:.3f} s")
    return split


def probe(ctx):
    """The probe's readings, run once a run and kept on ``ctx``."""
    if "program_probe" not in vars(ctx):
        ctx.program_probe = _probe(ctx)
    return ctx.program_probe


def read(ctx, key: str):
    """One reading of the probe, or None."""
    p = probe(ctx)
    return None if p is None else p.get(key)


def pack_seconds(ctx, phase: str, own: bool):
    """Seconds of a phase of the entry's packing (``dh.pack_times``): less
    the phases nested in it where ``own``. On the card only; None where
    the program keeps no such timer."""
    times = getattr(ctx.entry.dh, "pack_times", None)
    if not ctx.on_card or times is None or phase not in times.times:
        return None
    return times.own(phase) if own else times.times[phase]
