"""The device trace of whole solves, and its reduction.

``traced_solves`` runs solves of the cell's entry under ``torch.profiler``
(host and card), inside a span of the benchmark's own; ``summarize`` takes
from plain (name, start, end) intervals in microseconds:

- ``busy_s``: the union of the card's activity (kernels, copies, memsets)
  inside the span, and ``window_s``, the span's length;
- ``device_ops``: the card's operations that took most time, by name;
- ``idle_gaps``: the card's idle time inside the span, by what the host
  was doing when each gap began (the innermost operator or benchmark span
  open then; CUDA runtime calls are left out so that the operator that
  made them names the gap).
"""

from __future__ import annotations

import collections
import re
import time

TRACED = "amgbench.traced"
SOLVE = "amgbench.solve"
RUNTIME = re.compile(r"^cu(da)?[A-Z]")    # CUDA runtime and driver calls
TOP = 10


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals clipped to [lo, hi], as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The stretches of [lo, hi] that ``busy`` (sorted, disjoint) leaves
    free."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host, points) -> list:
    """For each of the sorted ``points``, the name of the innermost host
    interval ``(name, start, end)`` that holds it (intervals nest), or
    None."""
    host = sorted(host, key=lambda h: (h[1], -h[2]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][1] <= p:
            while stack and stack[-1][2] <= host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] <= p:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def _top(sums: dict) -> list:
    return [[name, sec] for name, sec in
            sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(window, device, host) -> dict:
    """``window`` (start, end), ``device`` and ``host`` lists of (name,
    start, end), all in microseconds."""
    lo, hi = window
    busy = union([(s, e) for _, s, e in device], lo, hi)
    ops = collections.defaultdict(float)
    for name, s, e in device:
        ops[name] += max(0.0, min(e, hi) - max(s, lo)) / 1e6
    free = gaps(busy, lo, hi)
    owners = innermost(host, [g[0] for g in free])
    idle = collections.defaultdict(float)
    count = collections.Counter()
    for (s, e), who in zip(free, owners):
        idle[who or "(no host span)"] += (e - s) / 1e6
        count[who or "(no host span)"] += 1
    return {"busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (hi - lo) / 1e6,
            "device_ops": _top(ops),
            "idle_gaps": [[f"{name} ({count[name]} gaps)", sec]
                          for name, sec in _top(idle)]}


def traced_solves(entry, pool, count: int = 2) -> dict:
    """``count`` solves of the entry, on the pool's first right-hand
    sides, under the profiler; ``summarize``'s dict, with the seconds the
    reduction took (``reduce_s``). Reads the profiler's raw events: the
    card's user annotations (the spans' copies on its timeline) are not
    its activity, and the host's CUDA runtime calls name no gap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(TRACED):
            for i in range(count):
                with record_function(SOLVE):
                    entry.solve(pool[i])
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    span = next(e for e in events if e.name() == TRACED
                and e.device_type() == DeviceType.CPU)
    device, host = [], []
    for e in events:
        iv = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and iv[0] not in (TRACED, SOLVE):
                device.append(iv)
        elif e.start_thread_id() == span.start_thread_id() and \
                not RUNTIME.match(iv[0]):
            host.append(iv)
    out = summarize((span.start_ns() / 1e3, span.end_ns() / 1e3), device,
                    host)
    out["reduce_s"] = time.perf_counter() - t0
    out["device_events"] = len(device)
    return out
