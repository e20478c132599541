"""The solves of the systems hierarchies of tests/test_torch_systems.py:
tests/test_fem.py::test_elasticity_systems_amg's configuration (24 x 24
Q1 elasticity, unknown-based CLJP + modified classical, SOR), set up by
each package and solved in float64 by each package's device hierarchy
(the port's on CPU tensors): JAX's V-cycles, residual histories equal to
1e-9. In a file of its own because JAX compiles its solve for each shard
count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from raptor_tpu.device import par as jpar  # noqa: E402
from raptor_tpu.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy as JaxDeviceHierarchy)
from raptor_tpu_torch.multilevel.device_hierarchy import (  # noqa: E402
    DeviceHierarchy)

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401
from test_torch_systems import _setups  # noqa: E402


@pytest.mark.parametrize("n_shards", [1, 4])
def test_elasticity_systems_solve_matches_jax(n_shards, monkeypatch):
    tml, jml, _ = _setups(n_shards, "global", monkeypatch)
    jdh = JaxDeviceHierarchy(jml, jpar.make_mesh(n_shards),
                             dtype=jnp.float64)
    tdh = DeviceHierarchy(tml, dtype=torch.float64, device="cpu")
    b = jml.levels[0].A.mult(np.ones(jml.levels[0].A.global_num_rows))
    jr = jdh.solve(jdh.vector(np.zeros_like(b)), jdh.vector(b))
    tr = tdh.solve(tdh.vector(np.zeros_like(b)), tdh.vector(b))
    assert tr.n_iters == int(jr.n_iters) < tml.max_iterations
    assert tr.res[tr.n_iters] < tml.solve_tol and not tr.stalled
    np.testing.assert_allclose(tr.res, np.asarray(jr.res), rtol=1e-9,
                               atol=1e-16)
