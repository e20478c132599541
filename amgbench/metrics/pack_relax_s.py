"""Seconds of the smoothers' plans: the phase "relax" of the entry's
``dh.pack_times`` (``device/relax.py:build_relax``, its Chebyshev bounds
by power iterations on the host) less the copies nested in it. The
packing's layer. Moves ``setup_s``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.pack_seconds(ctx, "relax", own=True)
