"""Host allocator tuning (copy of raptor_tpu.utils.hostmem): keep the
setup's large transient buffers in the persistent heap arena.

NumPy setup buffers are hundreds of MB, so glibc serves them with fresh
``mmap`` regions and returns them with ``munmap`` on free: every setup pass
first-touch-faults its whole working set again. ``pin_arena()`` raises the
malloc mmap / trim thresholds so that large buffers come from (and return
to) the persistent heap arena, and optionally pre-faults it once; later
setups reuse the pages already mapped. This is allocator configuration
only: no result changes. The arena is never trimmed, so the process's
peak resident set can only grow, and processes forked after the call
inherit the settings.
"""

from __future__ import annotations

import ctypes
import ctypes.util

# glibc mallopt parameter codes (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


_PINNED = False


def pin_arena(prefault_bytes: int = 0, chunk: int = 1 << 26) -> bool:
    """Route large allocations through the persistent heap arena and
    optionally pre-fault ``prefault_bytes`` of it. Returns False when the
    libc has no mallopt (non-glibc): a harmless no-op then. The thresholds
    are set once per process."""
    global _PINNED
    if _PINNED and prefault_bytes == 0:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    # never mmap per allocation; never trim the arena back to the OS
    ok1 = mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(1 << 30))
    ok2 = mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(-1))
    _PINNED = True
    if prefault_bytes > 0:
        import numpy as np
        blocks = []
        done = 0
        while done < prefault_bytes:
            n = min(chunk, prefault_bytes - done)
            a = np.empty(n, dtype=np.uint8)
            a[::4096] = 1          # touch every page
            blocks.append(a)
            done += n
        del blocks                  # stays in the arena (no trim)
    return bool(ok1 and ok2)
