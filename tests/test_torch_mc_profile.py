"""``DeviceHierarchy.profile_cycle`` / ``print_times`` across controllers.

``launch.run_controllers`` starts 2 and 4 gloo controllers on the CPU. Each
builds only its own rows of the 24^2 rotated anisotropic problem, runs
``spmd_rs_setup`` (HMIS + extended+i) over its ``SocketGroup`` and packs a
float64 Chebyshev ``from_spmd`` hierarchy with its ``comm``: with the plain
exchange, and on 4 controllers also with TAP on every level of a (2, 2)
layout (``tests/_torch_mc.py:profile``). Every controller calls
``profile_cycle`` and ``print_times`` together. Each must get rows with the
levels and keys of the stacked hierarchy's (``from_spmd`` of the same
setup with every shard in this process), finite positive times but for
``transfer_s``, which is 0 on the coarsest level only, the table of its
rows, and a V-cycle equal bit for bit before and after profiling. The
times are the CPU's and are checked for shape only. Its own file: it
starts processes.
"""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.comm import launch  # noqa: E402
from raptor_tpu_torch.comm.spmd import spmd_rs_setup  # noqa: E402
from raptor_tpu_torch.comm.transport import (  # noqa: E402
    InProcessTransport as TIT)
from raptor_tpu_torch.core.types import RelaxType  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as TDH)
from raptor_tpu_torch.utils.glibc_rand import form_rand_weights  # noqa

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

N = 24
REPS = 3
LAYOUTS = {2: (None,), 4: (None, (2, 2))}
CASES = [(world, layout) for world, layouts in LAYOUTS.items()
         for layout in layouts]
KEYS = {"level", "relax_s", "spmv_s", "transfer_s"}


@functools.lru_cache(maxsize=None)
def _controllers(world):
    return launch.run_controllers(world, "_torch_mc:profile",
                                  (N, LAYOUTS[world], REPS), device="cpu",
                                  timeout=300)


@functools.lru_cache(maxsize=None)
def _stacked_rows(world):
    """``profile_cycle``'s rows of the stacked hierarchy on ``world``
    shards (the plain exchange)."""
    A = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (N, N),
                             world)
    hier = spmd_rs_setup(A, form_rand_weights(N * N, 0), TIT)
    dh = TDH.from_spmd(hier, TIT, relax_type=RelaxType.Chebyshev,
                       device="cpu")
    return dh.profile_cycle(REPS)


def _runs(world, layout):
    return [out[layout] for out in _controllers(world)]


@pytest.mark.parametrize("world,layout", CASES)
def test_rows_have_the_stacked_levels_and_keys(world, layout):
    """Each controller's rows: one a level of the stacked hierarchy, in
    order, with the JAX row keys; TAP on every level where asked."""
    ref = _stacked_rows(world)
    assert len(ref) > 2
    for r, (out, run) in enumerate(zip(_controllers(world),
                                       _runs(world, layout))):
        assert out["rank"] == r
        assert [row["level"] for row in run["rows"]] == [
            row["level"] for row in ref]
        assert all(set(row) == KEYS for row in run["rows"])
        assert run["tap_levels"] == [layout is not None] * len(ref)


@pytest.mark.parametrize("world,layout", CASES)
def test_times_finite_and_positive(world, layout):
    """Every smoother and SpMV time finite and above 0 on every controller;
    the transfer round trip too but on the coarsest level, where it is
    0."""
    for run in _runs(world, layout):
        rows = run["rows"]
        for row in rows:
            assert math.isfinite(row["relax_s"]) and row["relax_s"] > 0
            assert math.isfinite(row["spmv_s"]) and row["spmv_s"] > 0
        assert all(math.isfinite(row["transfer_s"])
                   and row["transfer_s"] > 0 for row in rows[:-1])
        assert rows[-1]["transfer_s"] == 0.0


@pytest.mark.parametrize("world,layout", CASES)
def test_print_times_prints_each_level(world, layout):
    """``print_times`` across controllers: a header and one line a level,
    each starting with the level."""
    for run in _runs(world, layout):
        lines = run["table"].splitlines()
        assert lines[0].split()[0] == "lvl"
        assert [int(ln.split()[0]) for ln in lines[1:]] == [
            row["level"] for row in run["rows"]]


@pytest.mark.parametrize("world,layout", CASES)
def test_vcycle_unchanged_by_profiling(world, layout):
    """Profiling leaves the hierarchy as it was: a V-cycle after it equals
    one before it bit for bit on every controller."""
    for run in _runs(world, layout):
        assert np.isfinite(run["before"]).all()
        assert run["before"].tobytes() == run["after"].tobytes()
