"""Setup phase timers (copy of raptor_tpu.profiling.timers.Profiler).

The reference's per-level setup timers (par_multilevel.hpp:127-205,
track_times): named host wall-clock phases that accumulate over the
levels. Device work is timed with CUDA events where it runs.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
