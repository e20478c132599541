"""Device timing and the roofline arithmetic, kept with the benchmark.

Peaks are NVIDIA's published figures for one H100 SXM (80 GB HBM3) at its
700 W limit; a card set below that limit runs slower, so the run prints the
limit beside every share."""

from __future__ import annotations

import functools
import math
import subprocess
import time

import torch

PEAK_BYTES_PER_S = 3.35e12


def spmv_bytes(nnz: int, rows: int, cols: int, itemsize: int) -> int:
    """What y = A x needs to move at least: each nonzero's value, x and y
    once. The count comes from the benchmark's own CSR, so it is the same
    whatever format the program packs A in."""
    return (nnz + rows + cols) * itemsize


def roofline_percent(nbytes: int, seconds: float) -> float:
    """The least time the bytes take at the HBM peak, as a share of the
    measured time."""
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds


@functools.lru_cache(maxsize=None)
def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def kernel_ms(fn, reps: int = 50, warm: int = 3) -> float:
    """Device ms of one call with the host's launch cost kept out: the
    calls queue behind a spin kernel that lasts twice as long as the host
    takes to enqueue them, so the card runs them back to back; CUDA events
    around the batch, divided by ``reps``."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * (2 * reps * host_ms + 1)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def chain_ms(fn, least: int = 20, least_s: float = 0.5) -> dict:
    """A chain of calls, at least ``least`` and enough to span ``least_s``
    by the host clock: the device ms a call by CUDA events around the
    chain, and the host ms a call to enqueue it, before the synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(least, math.ceil(least_s / (time.perf_counter() - t0)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return {"device_ms": start.elapsed_time(end) / reps,
            "enqueue_ms": enqueue_s * 1e3 / reps, "calls": reps}


def power_limit() -> str:
    """The card's ``name, power.limit`` as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({e.__class__.__name__})"
