"""The benchmark's frozen stencil assembly against the port's gallery, and
the residual check."""

import numpy as np
import pytest
import scipy.sparse as sp

from amgbench.reference import assemble, diffusion_2d, laplace_27pt
from amgbench.reference.residual import relative_residual


@pytest.mark.parametrize("problem,grid", [
    ({"kind": "diffusion_2d", "eps": 0.001, "theta": np.pi / 8}, (13, 17)),
    ({"kind": "diffusion_2d", "eps": 1.0, "theta": 0.0}, (9, 5)),
    ({"kind": "laplace_27pt"}, (5, 6, 7)),
])
def test_assembly_equals_the_ports_stencil_grid(problem, grid):
    from raptor_tpu_torch.gallery import stencils
    ours = assemble({"problem": problem, "grid": list(grid)})
    if problem["kind"] == "diffusion_2d":
        st = stencils.diffusion_stencil_2d(problem["eps"], problem["theta"])
    else:
        st = stencils.laplace_stencil_27pt()
    port = stencils.par_stencil_grid(st, grid, 1).global_csr
    assert ours.has_sorted_indices
    np.testing.assert_array_equal(ours.indptr, port.indptr)
    np.testing.assert_array_equal(ours.indices, port.indices)
    np.testing.assert_array_equal(ours.data, port.data)


def test_stencils_match_the_ports_formulas():
    from raptor_tpu_torch.gallery import stencils
    np.testing.assert_array_equal(
        diffusion_2d.stencil(0.001, np.pi / 8),
        stencils.diffusion_stencil_2d(0.001, np.pi / 8))
    np.testing.assert_array_equal(laplace_27pt.stencil(),
                                  stencils.laplace_stencil_27pt())


def test_relative_residual():
    A = sp.csr_matrix(np.array([[4.0, -1.0], [-1.0, 4.0]]))
    x = np.array([1.0, 2.0])
    b = A @ x
    assert relative_residual(A, x, b) == 0.0
    assert relative_residual(A, x + [1e-3, 0], b) == pytest.approx(
        np.linalg.norm([4e-3, -1e-3]) / np.linalg.norm(b))
    assert relative_residual(A, np.array([np.nan, 0.0]), b) == np.inf
    assert relative_residual(A, np.zeros(3), b) == np.inf
