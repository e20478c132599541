"""The port's spans on the card: under ``torch.profiler`` the kernels'
launch calls fall inside the V-cycle's level-0 spans, and a recorded
``solve_mixed`` counts its blocking reads as on the CPU. Marked ``cuda``,
it skips without a card; it imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing_cuda.py -q
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from raptor_tpu_torch.core.types import (  # noqa: E402
    CoarsenType, InterpType, RelaxType)
from raptor_tpu_torch.device import kernels  # noqa: E402
from raptor_tpu_torch.gallery import stencils  # noqa: E402
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)
from raptor_tpu_torch.multilevel.par_multilevel import (  # noqa: E402
    ParRugeStubenSolver)
from raptor_tpu_torch.profiling.timers import recording, take  # noqa: E402

LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launches_lie_inside_the_cycle_spans(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    A = stencils.par_stencil_grid(
        stencils.diffusion_stencil_2d(0.001, np.pi / 8), (64, 64), 1)
    ml = ParRugeStubenSolver(0.25, CoarsenType.RS, InterpType.ModClassical,
                             relax_type=RelaxType.Chebyshev)
    ml.num_smooth_sweeps = 3
    ml.rap_mode = ml.interp_mode = "host"
    ml.setup(A)
    dh = DeviceHierarchy(ml, dtype=torch.float32, device=cuda)
    assert {"format", "relax", "copy", "coarse_lu"} <= set(dh.pack_times.times)
    x0 = np.zeros(A.global_num_rows)
    b = A.mult(np.ones(A.global_num_rows))
    dh.solve_mixed(x0, b, tol=1e-8)             # warm: the kernels load
    take()
    with recording():
        _, hist = dh.solve_mixed(x0, b, tol=1e-8)
    counters = take().counters
    assert counters == {"solves": 1, "syncs": len(hist) + 2,
                        "cycles": len(hist) - 1}

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dh.solve_mixed(x0, b, tol=1e-8)
        torch.cuda.synchronize()
    take()
    host = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]
    cycles = [(e.start_ns(), e.end_ns()) for e in host
              if e.name() == "raptor.vcycle.L0"]
    assert len(cycles) == len(hist) - 1
    launches = [e.start_ns() for e in host if LAUNCH.match(e.name())]
    inside = sum(1 for t in launches
                 if any(s <= t <= e for s, e in cycles))
    # every cycle launches the DIA / BDIA kernels and torch's own; the
    # float64 residuals between the cycles launch the rest
    assert sum(kernels.LAUNCHES.values()) > 0
    assert inside / len(cycles) > 10 and inside < len(launches)
