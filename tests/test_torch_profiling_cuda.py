"""The port's profiling layer on the card: ``profile_cycle`` /
``print_times``, ``pcg_time_split`` and ``device_trace`` on a 64^2
flagship hierarchy (DIA on the fine level, BDIA below). Marked ``cuda``,
it skips without a card; it imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling_cuda.py -q
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.gallery import stencils  # noqa: E402
from raptor_tpu_torch.krylov.profile import pcg_time_split  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.profiling.timers import device_trace  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_profiling_on_the_card(cuda, tmp_path):
    A = stencils.par_stencil_grid(
        stencils.diffusion_stencil_2d(0.001, np.pi / 8), (64, 64), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    dh = DeviceHierarchy(ml, dtype=torch.float32, device=cuda)
    b = dh.vector(A.mult(np.ones(A.global_num_rows)))
    rows = dh.profile_cycle(reps=5)
    assert len(rows) == len(dh.levels)
    for r in rows:
        assert r["relax_s"] > 0.0 and r["spmv_s"] > 0.0
        assert math.isfinite(r["relax_s"] + r["spmv_s"] + r["transfer_s"])
    assert rows[-1]["transfer_s"] == 0.0
    assert len(dh.print_times(reps=2).split("\n")) == len(dh.levels) + 1
    split = pcg_time_split(dh.levels[0].A, b, dh.precond_pack(), reps=5)
    assert all(split[k] > 0.0 for k in split)
    with device_trace(str(tmp_path)) as path:
        dh.vcycle(torch.zeros_like(b), b)
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"]
    assert any("bdia_spmv" in n for n in names)
    assert any("dia_spmv" in n and "bdia_spmv" not in n for n in names)
