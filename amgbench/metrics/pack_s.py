"""Seconds of packing the entry: the ``DeviceHierarchy`` in the mix's
precision and whatever else the entry solves with (the float64 fine
operator of the refinement's residuals), ``device/par.py:
device_put_matrix`` and ``device/formats.py``. Host clock, ended by a
synchronize. Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("pack")
