"""Seconds of the port's AMG setup, ``ml.setup(A)``: the host setup layer
(``multilevel/par_multilevel.py``, ``ruge_stuben/*``, the setup engines
``device/spgemm.py`` and ``device/interp.py``, ``native.py``). Host clock,
ended by a synchronize. Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("amg_setup")
