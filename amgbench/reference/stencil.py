"""Constant-coefficient stencil operators on a grid, as SciPy CSR.

The benchmark's own frozen copy of what its configurations state: a grid
of ``prod(grid)`` unknowns in row-major order (dimension 0 outermost), zero
Dirichlet boundaries, and a stencil of ``3 ** dim`` entries in row-major
order over the offsets (-1, 0, 1) of each dimension. Row ``i`` couples to
``i + o . strides`` for every offset ``o`` whose neighbour lies inside the
grid, with the value at the mirrored stencil position ``3 ** dim - 1 -
flat(o)`` (RAPtor's gallery/stencil.cpp). Entries of magnitude at most
``ZERO_TOL`` are left out. NumPy and SciPy only.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

ZERO_TOL = 1e-16


def assemble(stencil, grid) -> sp.csr_matrix:
    """The stencil operator on ``grid``: float64 CSR with sorted columns."""
    grid = [int(g) for g in grid]
    dim = len(grid)
    stencil = np.asarray(stencil, dtype=np.float64).ravel()
    if len(stencil) != 3 ** dim:
        raise ValueError(f"{len(stencil)} stencil entries for a "
                         f"{dim}-dimensional grid")
    n = int(np.prod(grid))
    strides = [int(np.prod(grid[d + 1:])) for d in range(dim)]

    entries = []
    for flat, offs in enumerate(itertools.product((-1, 0, 1), repeat=dim)):
        val = stencil[3 ** dim - 1 - flat]
        if abs(val) > ZERO_TOL:
            entries.append((sum(o * s for o, s in zip(offs, strides)),
                            val, offs))
    entries.sort(key=lambda e: e[0])        # ascending columns in each row

    idx = np.arange(n, dtype=np.int64)
    coords = [(idx // strides[d]) % grid[d] for d in range(dim)]
    mask = np.ones((n, len(entries)), dtype=bool)
    for k, (_, _, offs) in enumerate(entries):
        for d, o in enumerate(offs):
            if o == 1:
                mask[:, k] &= coords[d] < grid[d] - 1
            elif o == -1:
                mask[:, k] &= coords[d] > 0
    del coords
    diags = np.array([e[0] for e in entries], dtype=np.int64)
    vals = np.array([e[1] for e in entries], dtype=np.float64)
    indices = (idx[:, None] + diags[None, :])[mask]
    data = np.broadcast_to(vals, mask.shape)[mask]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(mask.sum(axis=1), out=indptr[1:])
    return sp.csr_matrix((data, indices, indptr), shape=(n, n))
