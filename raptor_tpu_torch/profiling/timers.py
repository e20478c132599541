"""Setup phase timers and the device trace (copy of
raptor_tpu.profiling.timers).

The reference's per-level setup timers (par_multilevel.hpp:127-205,
track_times): named host wall-clock phases that accumulate over the
levels. Device work is timed with CUDA events where it runs
(``DeviceHierarchy.profile_cycle``, ``krylov.profile``), and traced by
``device_trace``.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict

import torch


class Profiler:
    """Accumulating named wall-clock timers."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace around a block, written as a Chrome
    trace (``chrome://tracing``, Perfetto) into ``logdir``: host activity,
    and the card's kernels and copies when CUDA is present (the JAX
    package's ``jax.profiler`` trace). Yields the path of the trace file,
    which exists once the block has ended."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{time.time_ns()}.json")
    with profile(activities=activities) as prof:
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
