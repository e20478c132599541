"""Rotated anisotropic diffusion, the Q1 finite-element 9-point stencil
(RAPtor's gallery/diffusion.cpp, ``diffusion_stencil_2d(eps, theta)``).

A configuration's ``problem`` reads ``{"kind": "diffusion_2d", "eps": ...,
"theta": ...}`` beside its ``"grid": [nx, ny]``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgbench.reference.stencil import assemble as assemble_stencil


def stencil(eps: float, theta: float) -> np.ndarray:
    """The 3 x 3 stencil, row-major, of -div(Q diag(1, eps) Q^T grad u)
    with Q the rotation by ``theta``."""
    c, s = np.cos(theta), np.sin(theta)
    cs, cc, ss = c * s, c * c, s * s
    v1 = ((-eps - 1) * cc + (-eps - 1) * ss + (3 * eps - 3) * cs) / 6.0
    v2 = ((2 * eps - 4) * cc + (-4 * eps + 2) * ss) / 6.0
    v3 = ((-eps - 1) * cc + (-eps - 1) * ss + (-3 * eps + 3) * cs) / 6.0
    v4 = ((-4 * eps + 2) * cc + (2 * eps - 4) * ss) / 6.0
    v5 = ((8 * eps + 8) * cc + (8 * eps + 8) * ss) / 6.0
    return np.array([v1, v2, v3, v4, v5, v4, v3, v2, v1])


def assemble(problem: dict, grid) -> sp.csr_matrix:
    return assemble_stencil(stencil(problem["eps"], problem["theta"]), grid)
