"""The 27-point 3-D Laplacian: 26 on the diagonal, -1 to each of the 26
neighbours (HPCG's operator; RAPtor's gallery/laplacian27pt.cpp).

A configuration's ``problem`` reads ``{"kind": "laplace_27pt"}`` beside its
``"grid": [nx, ny, nz]``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amgbench.reference.stencil import assemble as assemble_stencil


def stencil() -> np.ndarray:
    st = np.full(27, -1.0)
    st[13] = 26.0
    return st


def assemble(problem: dict, grid) -> sp.csr_matrix:
    return assemble_stencil(stencil(), grid)
