"""Classical strength of connection (copy of raptor_tpu.ruge_stuben.strength,
classical, single-variable).

Hypre-compatible classical strength (strength.cpp:12-198 /
par_strength.cpp:14-346): the diagonal is always kept; if a_ii < 0 the row
scale is the max off-diagonal value and entries with ``val > theta*scale``
are strong, otherwise the min and ``val < theta*scale``. S keeps A's values
on the kept pattern.
"""

from __future__ import annotations

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix


def classical_strength(a: CSRMatrix, theta: float = 0.25) -> CSRMatrix:
    indptr, indices, data = native.classical_strength_csr(
        a.indptr, a.indices, a.data, theta)
    return CSRMatrix(a.n_rows, a.n_cols, indptr, indices, data)


def strength(a: ParCSRMatrix, theta: float = 0.25) -> ParCSRMatrix:
    """ParCSRMatrix::strength (par_strength.cpp:541), classical."""
    return ParCSRMatrix(classical_strength(a.global_csr, theta), a.partition)
