"""Finite-element problem gallery (copy of raptor_tpu.gallery.fem: the Q1
Laplacian and plane-stress elasticity here, the discontinuous-Galerkin and
vector kinds in ``gallery/dg.py``).

The reference exposes FE problems through an optional MFEM wrapper
(external/mfem_wrapper.hpp:15-45); without MFEM the gallery assembles the
canonical problems directly on a structured 2-D grid. Elasticity produces
the 2-dofs-per-node systems that blocked (BSR) AMG is built for. Assembly
makes the same numpy/scipy calls in the same order as the JAX package's,
so both galleries give bit-equal matrices.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition

def _q1_grid(nx: int, ny: int):
    """Node ids [ny+1, nx+1] and element connectivity [nel, 4]
    (counter-clockwise local order)."""
    nodes = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    e00 = nodes[:-1, :-1].reshape(-1)
    conn = np.stack([e00, e00 + 1, e00 + nx + 2, e00 + nx + 1], axis=1)
    return nodes, conn


def _q1_laplace_element(hx: float, hy: float) -> np.ndarray:
    """Exact 4x4 Q1 stiffness for -div(grad u) on an hx x hy rectangle."""
    a = hy / hx
    b = hx / hy
    k = np.array([
        [2 * (a + b), -2 * a + b, -a - b, a - 2 * b],
        [-2 * a + b, 2 * (a + b), a - 2 * b, -a - b],
        [-a - b, a - 2 * b, 2 * (a + b), -2 * a + b],
        [a - 2 * b, -a - b, -2 * a + b, 2 * (a + b)],
    ]) / 6.0
    return k


def q1_laplacian(nx: int, ny: int) -> CSRMatrix:
    """Q1 FE Laplacian on an nx x ny element grid with homogeneous
    Dirichlet boundary (interior nodes only): the 9-point FE stencil."""
    hx, hy = 1.0 / nx, 1.0 / ny
    nodes, conn = _q1_grid(nx, ny)
    ke = _q1_laplace_element(hx, hy)
    nel = conn.shape[0]
    rows = np.repeat(conn, 4, axis=1).reshape(-1)
    cols = np.tile(conn, (1, 4)).reshape(-1)
    vals = np.tile(ke.reshape(-1), nel)
    n = (nx + 1) * (ny + 1)
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    # eliminate boundary nodes
    interior = np.ones(n, dtype=bool)
    interior[nodes[0, :]] = interior[nodes[-1, :]] = False
    interior[nodes[:, 0]] = interior[nodes[:, -1]] = False
    K = K[interior][:, interior].tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return CSRMatrix.from_scipy(K)


def _q1_elasticity_element(hx: float, hy: float, E: float,
                           nu: float) -> np.ndarray:
    """8x8 Q1 plane-stress elasticity element (2x2 Gauss), dofs ordered
    (ux0, uy0, ux1, uy1, ...)."""
    D = (E / (1 - nu * nu)) * np.array([
        [1.0, nu, 0.0],
        [nu, 1.0, 0.0],
        [0.0, 0.0, (1 - nu) / 2.0],
    ])
    gp = np.array([-1.0, 1.0]) / np.sqrt(3.0)
    ke = np.zeros((8, 8))
    for xi in gp:
        for eta in gp:
            # Q1 shape gradients on [-1,1]^2, CCW node order
            dN = 0.25 * np.array([
                [-(1 - eta), (1 - eta), (1 + eta), -(1 + eta)],
                [-(1 - xi), -(1 + xi), (1 + xi), (1 - xi)],
            ])
            J = np.diag([hx / 2.0, hy / 2.0])
            dNx = np.linalg.solve(J, dN)       # [2, 4]
            B = np.zeros((3, 8))
            B[0, 0::2] = dNx[0]
            B[1, 1::2] = dNx[1]
            B[2, 0::2] = dNx[1]
            B[2, 1::2] = dNx[0]
            ke += B.T @ D @ B * (hx * hy / 4.0)
    return ke


def q1_linear_elasticity(nx: int, ny: int, E: float = 1.0,
                         nu: float = 0.3):
    """Plane-stress linear elasticity on an nx x ny Q1 grid, clamped on
    the left edge (mfem_linear_elasticity.cpp equivalent).

    Returns (K: CSRMatrix with 2 dofs/node interleaved,
    variables: per-dof variable ids {0,1} for unknown-based AMG)."""
    hx, hy = 1.0 / nx, 1.0 / ny
    nodes, conn = _q1_grid(nx, ny)
    ke = _q1_elasticity_element(hx, hy, E, nu)
    nel = conn.shape[0]
    # element dof ids: [nel, 8]
    edofs = np.empty((nel, 8), dtype=np.int64)
    edofs[:, 0::2] = 2 * conn
    edofs[:, 1::2] = 2 * conn + 1
    rows = np.repeat(edofs, 8, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, 8)).reshape(-1)
    vals = np.tile(ke.reshape(-1), nel)
    n = 2 * (nx + 1) * (ny + 1)
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    # clamp the left edge (both components)
    fixed_nodes = nodes[:, 0]
    free = np.ones(n, dtype=bool)
    free[2 * fixed_nodes] = free[2 * fixed_nodes + 1] = False
    K = K[free][:, free].tocsr()
    K.sum_duplicates()
    K.sort_indices()
    variables = (np.arange(n)[free]) % 2
    return CSRMatrix.from_scipy(K), variables.astype(np.int64)


def par_fem(kind: str, nx: int, ny: int, n_shards: int, **kw):
    """Partitioned FE gallery entry, the reference's six MFEM problems
    (external/mfem_wrapper.hpp:15-45): ``kind`` in {"laplace",
    "elasticity", "dg_diffusion", "dg_elasticity", "grad_div",
    "adaptive_laplacian"}. "elasticity" and "dg_elasticity" return the
    pair (ParCSRMatrix, per-dof variable ids), the others the
    ParCSRMatrix; "adaptive_laplacian" takes ``nx`` as its coarse cells
    and ignores ``ny``."""
    from raptor_tpu_torch.gallery import dg
    variables = None
    if kind == "laplace":
        a = q1_laplacian(nx, ny)
    elif kind == "elasticity":
        a, variables = q1_linear_elasticity(nx, ny, **kw)
    elif kind == "dg_diffusion":
        a = dg.dg_diffusion(nx, ny, **kw)
    elif kind == "dg_elasticity":
        a = dg.dg_elasticity(nx, ny, **kw)
        variables = (np.arange(a.n_rows) % 2).astype(np.int64)
    elif kind == "grad_div":
        a = dg.grad_div(nx, ny, **kw)
    elif kind == "adaptive_laplacian":
        a = dg.adaptive_laplacian(nx, **kw)
    else:
        raise ValueError(kind)
    part = Partition.create(a.n_rows, a.n_cols, n_shards)
    pa = ParCSRMatrix(a, part)
    return (pa, variables) if variables is not None else pa
