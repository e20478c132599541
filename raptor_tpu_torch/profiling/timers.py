"""Setup phase timers, the program's spans and counters, and the device
trace (the timers a copy of raptor_tpu.profiling.timers).

The reference's per-level setup timers (par_multilevel.hpp:127-205,
track_times): named host wall-clock phases that accumulate over the
levels (``Profiler``, always on). Device work is timed with CUDA events
where it runs (``DeviceHierarchy.profile_cycle``, ``krylov.profile``), and
traced by ``device_trace``.

Spans and counters mark the program's own steps (the solve, each level of
the V-cycle, the packing). They record only while active: inside
``recording()``, or while a ``torch.profiler`` records. Otherwise ``span``
returns one shared object that does nothing and ``count`` returns at once.
An active span keeps ``(name, start_ns, end_ns, parent, solve_id)`` on
``time.perf_counter_ns`` until ``take()``, and opens a profiler range
named ``name`` where a profiler records, so that the span lies in its
trace on the clock of the card's kernels and copies. The range is torch's
``_RecordFunctionFast``, what ``torch.profiler.record_function`` records
at about a tenth of its host cost (2-3 us a span against 15-25 us), so
that a traced solve stays near an untraced one. Spans of one thread nest;
the recorder is the process's.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SYNC = "raptor.sync"        # ``sync_span``


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]       # None while the span is still open
    parent: Optional[int]       # index of the enclosing span in the list
    solve_id: Optional[int]     # the solve it belongs to, None outside one


class Recorded(NamedTuple):
    spans: List[SpanRecord]     # in the order they opened
    counters: Dict[str, int]


class _Recorder:
    def __init__(self):
        self.depth = 0          # recording() blocks open
        self.spans = []         # _Span objects, in the order they opened
        self.counters = Counter()
        self.open = []          # the open spans, innermost last
        self.solve_id = None
        self.solves = 0         # solve ids handed out in this process


_REC = _Recorder()


class _Off:
    """The span while recording is off: one shared object."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "solve_id",
                 "_opens_solve", "_outer_solve", "_rf")

    def __init__(self, name: str, opens_solve: bool, profiled: bool):
        self.name = name
        self._opens_solve = opens_solve
        self._rf = torch._C._profiler._RecordFunctionFast(name) \
            if profiled else None

    def __enter__(self):
        rec = _REC
        if self._opens_solve:
            rec.solves += 1
            rec.counters["solves"] += 1
            self._outer_solve = rec.solve_id
            rec.solve_id = rec.solves
        self.parent = rec.open[-1] if rec.open else None
        self.solve_id = rec.solve_id
        self.end_ns = None
        rec.open.append(self)
        rec.spans.append(self)
        if self._rf is not None:
            self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        rec = _REC
        rec.open.pop()
        if self._opens_solve:
            rec.solve_id = self._outer_solve
        return False


def span(name: str):
    """A context manager that marks a step of the program as ``name``
    (``raptor.`` first). Build a name that varies (a level's) once, where
    the plan is packed, never per call."""
    profiled = _autograd_profiler._is_profiler_enabled
    if not (_REC.depth or profiled):
        return _OFF
    return _Span(name, False, profiled)


def solve_span(name: str):
    """``span(name)`` around a whole solve: the spans inside it carry a new
    ``solve_id``, and it counts one of ``solves``."""
    profiled = _autograd_profiler._is_profiler_enabled
    if not (_REC.depth or profiled):
        return _OFF
    return _Span(name, True, profiled)


def sync_span():
    """The span ``raptor.sync`` around a blocking card-to-host read of a
    solve's scalars, counted as one of ``syncs``."""
    count("syncs")
    return span(SYNC)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording is active."""
    if _REC.depth or _autograd_profiler._is_profiler_enabled:
        _REC.counters[name] += n


@contextlib.contextmanager
def recording():
    """Spans and counters record inside the block (as they do while a
    ``torch.profiler`` records); ``take()`` returns them."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def take() -> Recorded:
    """The spans and counters recorded so far, which it clears. A span
    still open is returned with ``end_ns`` None."""
    rec = _REC
    spans, counters = rec.spans, dict(rec.counters)
    rec.spans, rec.counters = [], Counter()
    index = {id(s): i for i, s in enumerate(spans)}
    return Recorded([SpanRecord(s.name, s.start_ns, s.end_ns,
                                index.get(id(s.parent)), s.solve_id)
                     for s in spans], counters)


# the Profiler phases open now, innermost last: (profiler, name)
_PHASES: list = []


class Profiler:
    """Accumulating named wall-clock timers, always on. Each phase is also
    the span ``prefix + name``. A phase opened inside another phase of the
    same Profiler adds its seconds to that one's ``nested``, so that
    ``own(name)`` is the phase's time less the phases nested in it."""

    def __init__(self, prefix: str = "raptor."):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.nested: Dict[str, float] = defaultdict(float)
        self.prefix = prefix
        self._span_names: Dict[str, str] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        span_name = self._span_names.setdefault(name, self.prefix + name)
        outer = _PHASES[-1] if _PHASES else None
        _PHASES.append((self, name))
        t0 = time.perf_counter()
        try:
            with span(span_name):
                yield
        finally:
            dt = time.perf_counter() - t0
            _PHASES.pop()
            self.times[name] += dt
            self.counts[name] += 1
            if outer is not None and outer[0] is self:
                self.nested[outer[1]] += dt

    def own(self, name: str) -> float:
        """Seconds of phase ``name`` less those of the phases nested in
        it."""
        return self.times.get(name, 0.0) - self.nested.get(name, 0.0)

    def tally(self, name: str, n: int = 1) -> None:
        """Counts ``n`` of ``name`` here, with no time, whether or not
        spans record, and as the counter ``name`` where they do."""
        self.counts[name] += n
        count(name, n)


def nested_phase(name: str):
    """Phase ``name`` of the Profiler whose phase is open innermost (the
    copies of a packing inside its ``format`` or ``relax``); outside any
    phase, a span that does nothing while recording is off."""
    if _PHASES:
        return _PHASES[-1][0].phase(name)
    return span("raptor." + name)


# the builds of native code in this process: the CUDA kernels' nvcc runs
# (``device.kernels.build``) and the host library's (``native``), kept
# whether or not spans record; ``counts["builds"]`` counts compiler runs
BUILDS = Profiler()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace around a block, written as a Chrome
    trace (``chrome://tracing``, Perfetto) into ``logdir``: host activity,
    and the card's kernels and copies when CUDA is present (the JAX
    package's ``jax.profiler`` trace), with the program's spans in it;
    ``take()`` returns them and the counters afterwards. Yields the path
    of the trace file, which exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    with recording(), profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def rescale(y: torch.Tensor) -> torch.Tensor:
    """y / (1 + max |y|) per shard (row of a stacked ``[S, R]`` vector):
    what keeps a chain of applications finite."""
    return y / (1.0 + y.abs().amax(dim=1, keepdim=True))


def interleaved_seconds(chains: dict, reps: int, warm: int = 2) -> dict:
    """Seconds of one step of each chain ``name: (step, x, carry)``: after
    ``warm`` steps, ``reps`` more, each fed the one before's result as
    ``x = carry(step(x))`` (``carry`` None: ``x = step(x)``). The median
    over ``reps`` rounds, each round one step of every chain in turn, so
    that a spell of a slower host weighs on every chain alike and the
    median drops it. Only ``step`` is timed,
    ``carry`` (a rescale that keeps the chain finite) is not: on a card a
    pair of CUDA events around each ``step`` and one synchronize at the
    end, so a step whose enqueue outlasts its kernels counts its enqueue,
    as it does in a cycle; the host clock around each ``step``
    elsewhere."""
    state, carries = {}, {}
    for name, (step, x, carry) in chains.items():
        carries[name] = carry or (lambda y: y)
        for _ in range(warm):
            x = carries[name](step(x))
        state[name] = x
    on_card = any(x.device.type == "cuda" for x in state.values())
    if on_card:
        torch.cuda.synchronize()
    spans = {name: [] for name in chains}
    for _ in range(reps):
        for name, (step, _, _) in chains.items():
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                y = step(state[name])
                end.record()
                spans[name].append((start, end))
            else:
                t0 = time.perf_counter()
                y = step(state[name])
                spans[name].append(time.perf_counter() - t0)
            state[name] = carries[name](y)
    if on_card:
        torch.cuda.synchronize()
        spans = {name: [s.elapsed_time(e) / 1e3 for s, e in pairs]
                 for name, pairs in spans.items()}
    return {name: statistics.median(ts) for name, ts in spans.items()}
