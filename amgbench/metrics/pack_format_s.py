"""Seconds of the packing's host side: the phase "format" of the
entry's ``dh.pack_times`` (``device/par.py:device_put_matrix``: comm
plan, format choice, layout arrays, embeddings; the P^T transposes; the
float64 fine operator of the residuals) less the copies nested in it. The
packing's layer. Moves ``setup_s``."""

from amgbench import program_trace


def read(ctx):
    return program_trace.pack_seconds(ctx, "format", own=True)
