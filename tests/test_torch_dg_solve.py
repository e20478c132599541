"""tests/test_fem.py::test_fem_gallery_amg_solves's grad-div solve (16 x
12, 4 shards) on the port against the JAX package's (see
tests/test_torch_dg.py): in a file of its own, as its JAX compile takes
most of a minute.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import _one_intra_op_thread  # noqa: E402,F401
from test_torch_dg import check_amg_pcg  # noqa: E402


def test_grad_div_amg_pcg_matches_jax():
    check_amg_pcg("grad_div", (16, 12))
