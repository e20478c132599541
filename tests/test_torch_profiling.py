"""The port's profiling layer on the CPU: the communication model
(``profiling.comm_model``) equal to the JAX package's field by field on
tests/test_aux.py's plans, ``DeviceHierarchy.profile_cycle`` /
``print_times`` (JAX's rows and table), ``krylov.profile.pcg_time_split``,
``profiling.timers.device_trace`` and the raise across controllers. The
times are the CPU's and are checked for shape only; the card's case is in
tests/test_torch_profiling_cuda.py, which imports no JAX.
"""

import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu.comm.plan import build_comm_plan as jbuild_plan  # noqa
from raptor_tpu.comm.tap import build_tap_plan as jbuild_tap  # noqa: E402
from raptor_tpu.gallery import stencils as jst  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu.profiling import comm_model as jcm  # noqa: E402
from raptor_tpu_torch.comm.plan import build_comm_plan  # noqa: E402
from raptor_tpu_torch.comm.tap import build_tap_plan  # noqa: E402
from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.device import par as tpar  # noqa: E402
from raptor_tpu_torch.gallery import stencils as tst  # noqa: E402
from raptor_tpu_torch.krylov.profile import pcg_time_split  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.profiling import comm_model as tcm  # noqa: E402
from raptor_tpu_torch.profiling.timers import (  # noqa: E402
    device_trace, interleaved_seconds, rescale)

from _torch_parity import ANISO  # noqa: E402
from _torch_parity import _one_intra_op_thread  # noqa: E402,F401

KEYS = ["level", "relax_s", "spmv_s", "transfer_s"]


def _lap27():
    """tests/test_aux.py:test_comm_model's matrix: the 27-point Laplacian
    on 10^3, 8 shards."""
    return (tst.par_stencil_grid(tst.laplace_stencil_27pt(), (10, 10, 10),
                                 8),
            jst.par_stencil_grid(jst.laplace_stencil_27pt(), (10, 10, 10),
                                 8))


@pytest.mark.parametrize("shards_per_host", [4, 2, None])
def test_model_comm_plan_matches_jax(shards_per_host):
    tA, jA = _lap27()
    got = tcm.model_comm_plan(build_comm_plan(tA),
                              shards_per_host=shards_per_host)
    ref = jcm.model_comm_plan(jbuild_plan(jA),
                              shards_per_host=shards_per_host)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert str(got) == str(ref)
    if shards_per_host:
        assert got.inter_host_bytes > 0 and got.max_bytes_per_host_pair > 0


@pytest.mark.parametrize("layout", [(2, 4), (4, 2)])
def test_model_tap_plan_matches_jax(layout):
    tA, jA = _lap27()
    tap = build_tap_plan(tA, *layout)
    got = tcm.model_tap_plan(tap)
    ref = jcm.model_tap_plan(jbuild_tap(jA, *layout))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert str(got) == str(ref)
    # tests/test_aux.py:13-41's checks, on the port's figures
    plain = tcm.model_comm_plan(build_comm_plan(tA),
                                shards_per_host=layout[1])
    assert got.inter_host_bytes <= plain.inter_host_bytes
    steps = got.steps
    assert set(steps) == {"L", "S", "G", "R"}
    assert steps["G"].inter_host_bytes == tap.dcn_values * 8
    assert got.inter_host_bytes == steps["G"].inter_host_bytes
    for s in ("L", "S", "R"):
        assert steps[s].inter_host_bytes == 0
    assert got.intra_host_bytes == sum(steps[s].intra_host_bytes
                                       for s in ("L", "S", "R"))
    for cls in tcm.CLASSES:
        assert got.n_msgs.get(cls, 0) == sum(st.n_msgs.get(cls, 0)
                                             for st in steps.values())
    assert got.max_msgs_per_shard > 0 and got.max_bytes_per_host_pair > 0


def _hierarchy(tap_amg=-1):
    """A 32^2 flagship hierarchy on 4 shards (CLJP + modified classical,
    Chebyshev(3)), float64 on CPU tensors; with ``tap_amg`` 0 every level
    exchanges through TAP as 2 x 2."""
    ml = ParRugeStubenSolver(0.25, CoarsenType.CLJP, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.tap_amg = tap_amg
    A = tst.par_stencil_grid(tst.diffusion_stencil_2d(*ANISO), (32, 32), 4)
    ml.setup(A)
    dh = DeviceHierarchy(ml, device="cpu",
                         mesh=tpar.make_mesh2(2, 2) if tap_amg >= 0 else None)
    return dh, dh.vector(A.mult(np.ones(A.global_num_rows)))


@pytest.mark.parametrize("tap_amg", [-1, 0])
def test_profile_cycle_rows(tap_amg):
    dh, b = _hierarchy(tap_amg)
    before = dh.vcycle(torch.zeros_like(b), b)
    rows = dh.profile_cycle(reps=3)
    assert [list(r) for r in rows] == [KEYS] * len(dh.levels)
    assert [r["level"] for r in rows] == list(range(len(dh.levels)))
    for r in rows:
        for k in KEYS[1:]:
            assert math.isfinite(r[k]) and r[k] >= 0.0
        assert r["relax_s"] > 0.0 and r["spmv_s"] > 0.0
    assert rows[-1]["transfer_s"] == 0.0
    assert all(r["transfer_s"] > 0.0 for r in rows[:-1])
    # the hierarchy is left as it was
    assert torch.equal(dh.vcycle(torch.zeros_like(b), b), before)


def test_print_times_matches_jax(monkeypatch):
    """The port's table equals JAX's ``print_times`` over the same rows;
    the real call prints one line a level under that header."""
    dh, _ = _hierarchy()
    rows = [{"level": 0, "relax_s": 1.25e-3, "spmv_s": 2.5e-4,
             "transfer_s": 6.0e-4},
            {"level": 1, "relax_s": 3e-5, "spmv_s": 1.5e-5,
             "transfer_s": 0.0}]
    ref = JaxDeviceHierarchy.print_times(
        types.SimpleNamespace(profile_cycle=lambda reps: rows), 7)
    real = dh.print_times(reps=2).split("\n")
    assert real[0] == ref.split("\n")[0]
    assert len(real) == len(dh.levels) + 1
    monkeypatch.setattr(dh, "profile_cycle", lambda reps: rows)
    assert dh.print_times(7) == ref


def test_pcg_time_split_keys():
    dh, b = _hierarchy()
    A = dh.levels[0].A
    plain = pcg_time_split(A, b, reps=3)
    assert sorted(plain) == ["comm_t", "precond_t", "spmv_t", "total_t"]
    assert plain["precond_t"] == 0.0
    pre = pcg_time_split(A, b, dh.precond_pack(), reps=3)
    for out in (plain, pre):
        for k in ("total_t", "spmv_t", "comm_t"):
            assert math.isfinite(out[k]) and out[k] > 0.0
    assert pre["precond_t"] > 0.0


def test_interleaved_seconds_times_each_step_alone():
    """Chains run in turn, one step of each a round, each timed alone on
    its own state; the carry between steps (the rescale) is not timed,
    and each step is fed the carried result of the one before."""
    import time
    seen = []

    def step(x):
        seen.append(float(x[0, 0]))
        return x * 4.0

    def slow_carry(y):
        time.sleep(0.02)
        return rescale(y)

    def slow(x):
        time.sleep(0.01)
        return x + 1.0

    out = interleaved_seconds(
        {"fed": (step, torch.ones(1, 4, dtype=torch.float64), slow_carry),
         "slow": (slow, torch.zeros(1, 2), None)}, 5)
    assert list(out) == ["fed", "slow"]
    assert 0.0 <= out["fed"] < 0.01 and out["slow"] >= 0.009
    assert seen[:3] == [1.0, 4.0 / 5.0, (16.0 / 5.0) / (1.0 + 16.0 / 5.0)]
    assert len(seen) == 7


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    dh, b = _hierarchy()
    with device_trace(str(tmp_path / "trace")) as path:
        dh.vcycle(torch.zeros_like(b), b)
    assert os.path.dirname(path) == str(tmp_path / "trace")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_profile_cycle_across_controllers_raises(monkeypatch):
    dh, _ = _hierarchy()
    monkeypatch.setattr(dh, "comm", object())
    with pytest.raises(NotImplementedError, match="item 24"):
        dh.profile_cycle()
