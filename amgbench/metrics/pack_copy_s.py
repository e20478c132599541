"""Seconds of the packing's host-to-card copies: the phase "copy" of
the entry's ``dh.pack_times``, the pageable copies of the packed
operators and smoother plans, which block the host. The packing's layer.
Moves ``setup_s``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.pack_seconds(ctx, "copy", own=False)
