"""Problem gallery: structured stencil matrices (copy of
raptor_tpu.gallery.stencils).

Equivalents of the reference's gallery (gallery/diffusion.cpp,
gallery/laplacian27pt.cpp, gallery/stencil.cpp:8, gallery/par_stencil.cpp:6).
A stencil entry at offset vector ``o`` contributes value ``stencil[-o]`` to
``A[i, i+dot(o,strides)]`` wherever all coordinates ``c + o`` stay inside the
grid (zero Dirichlet boundary).
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.core.types import ZERO_TOL
from raptor_tpu_torch.utils.hostmem import pin_arena


def diffusion_stencil_2d(eps: float = 1.0, theta: float = 0.0) -> np.ndarray:
    """Rotated anisotropic diffusion Q1 FE stencil
    (gallery/diffusion.cpp:55-82). Returns a length-9 array (3x3 row-major)."""
    c, s = np.cos(theta), np.sin(theta)
    cs, cc, ss = c * s, c * c, s * s
    val1 = ((-1 * eps - 1) * cc + (-1 * eps - 1) * ss + (3 * eps - 3) * cs) / 6.0
    val2 = ((2 * eps - 4) * cc + (-4 * eps + 2) * ss) / 6.0
    val3 = ((-1 * eps - 1) * cc + (-1 * eps - 1) * ss + (-3 * eps + 3) * cs) / 6.0
    val4 = ((-4 * eps + 2) * cc + (2 * eps - 4) * ss) / 6.0
    val5 = ((8 * eps + 8) * cc + (8 * eps + 8) * ss) / 6.0
    return np.array([val1, val2, val3, val4, val5, val4, val3, val2, val1])


def laplace_stencil_27pt() -> np.ndarray:
    """27-point 3-D Laplacian stencil (gallery/laplacian27pt.cpp:22-34)."""
    st = np.full(27, -1.0)
    st[13] = 26.0
    return st


def stencil_grid(stencil: np.ndarray, grid, dim: int = None) -> CSRMatrix:
    """Assemble the stencil operator on a ``grid`` with zero Dirichlet
    boundaries (gallery/stencil.cpp:8-196). Row-major grid ordering:
    dimension 0 is outermost."""
    grid = list(grid)
    if dim is None:
        dim = len(grid)
    stencil = np.asarray(stencil, dtype=np.float64).ravel()
    if len(stencil) != 3 ** dim:
        raise ValueError(f"stencil of {len(stencil)} entries for dim {dim}")
    # large outputs (1.3 GB at 128^3): through the persistent heap arena,
    # so that later setup passes reuse their pages (utils/hostmem.py)
    pin_arena()

    n_v = int(np.prod(grid))
    strides = np.ones(dim, dtype=np.int64)
    for d in range(dim - 2, -1, -1):
        strides[d] = strides[d + 1] * grid[d + 1]

    entries = []  # (diag, val, offs) for each nonzero stencil entry
    for flat, offs in enumerate(itertools.product((-1, 0, 1), repeat=dim)):
        # the value applied at offset `offs` is the entry at the REVERSED
        # position (stencil.cpp:171-180: value = data[N_s-d-1])
        val = stencil[3 ** dim - 1 - flat]
        if abs(val) <= ZERO_TOL:
            continue
        diag = sum(int(o) * int(strides[d]) for d, o in enumerate(offs))
        entries.append((diag, float(val), offs))

    diags = np.array([e[0] for e in entries], dtype=np.int64)
    if len(entries) and len(np.unique(diags)) == len(entries):
        # every offset is a distinct constant diagonal: one native pass
        # emits the sorted CSR directly
        from raptor_tpu_torch import native
        order = np.argsort(diags, kind="stable")
        dcols = np.array([entries[o][0] for o in order], dtype=np.int64)
        dvals = np.array([entries[o][1] for o in order])
        offs = np.array([entries[o][2] for o in order], dtype=np.int64)
        indptr, indices, data = native.stencil_csr(
            np.asarray(grid, dtype=np.int64), dcols, dvals, offs)
        return CSRMatrix(n_v, n_v, indptr, indices, data)

    idx = np.arange(n_v, dtype=np.int64)
    coords = [(idx // strides[d]) % grid[d] for d in range(dim)]
    rows_list, cols_list, vals_list = [], [], []
    for diag, val, offs in entries:
        mask = np.ones(n_v, dtype=bool)
        for d, o in enumerate(offs):
            if o == 1:
                mask &= coords[d] < grid[d] - 1
            elif o == -1:
                mask &= coords[d] > 0
        r = idx[mask]
        rows_list.append(r)
        cols_list.append(r + diag)
        vals_list.append(np.full(len(r), val))
    m = sp.csr_matrix(
        (np.concatenate(vals_list),
         (np.concatenate(rows_list), np.concatenate(cols_list))),
        shape=(n_v, n_v))
    m.sum_duplicates()
    m.sort_indices()
    return CSRMatrix.from_scipy(m)


def par_stencil_grid(stencil: np.ndarray, grid, n_shards: int,
                     dim: int = None) -> ParCSRMatrix:
    """Distributed stencil operator (gallery/par_stencil.cpp:6-228)."""
    a = stencil_grid(stencil, grid, dim)
    return ParCSRMatrix(a, Partition.create(a.n_rows, a.n_cols, n_shards))
