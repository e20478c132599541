"""Strength of connection (copy of raptor_tpu.ruge_stuben.strength).

- classical (hypre-compatible) strength: strength.cpp:12-198 /
  par_strength.cpp:14-346. The diagonal is always kept; if a_ii < 0 the row
  scale is the max off-diagonal value and entries with ``val > theta*scale``
  are strong, otherwise the min and ``val < theta*scale``. Unknown-based
  (systems) AMG passes each row's variable id (``variables``,
  ``num_variables`` > 1): only same-variable off-diagonals set the scale
  and can be strong.
- symmetric (smoothed-aggregation) strength: strength.cpp:200-325. An
  off-diagonal entry is kept if it is strong by its row's threshold OR by
  its column's.

S keeps A's values on the kept pattern.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import StrengthType


def classical_strength(a: CSRMatrix, theta: float = 0.25,
                       num_variables: int = 1,
                       variables: Optional[np.ndarray] = None) -> CSRMatrix:
    indptr, indices, data = native.classical_strength_csr(
        a.indptr, a.indices, a.data, theta,
        variables if num_variables != 1 else None, num_variables)
    return CSRMatrix(a.n_rows, a.n_cols, indptr, indices, data)


def symmetric_strength(a: CSRMatrix, theta: float = 0.25) -> CSRMatrix:
    indptr, indices, data = native.symmetric_strength_csr(
        a.indptr, a.indices, a.data, theta)
    return CSRMatrix(a.n_rows, a.n_cols, indptr, indices, data)


def strength(a, strength_type: StrengthType = StrengthType.Classical,
             theta: float = 0.25, num_variables: int = 1,
             variables: Optional[np.ndarray] = None):
    """Dispatch (CSRMatrix::strength, strength.cpp:328 /
    ParCSRMatrix::strength, par_strength.cpp:541) on a CSRMatrix or a
    ParCSRMatrix, which keeps its partition. The variables reach classical
    strength only, as in the reference."""
    if isinstance(a, ParCSRMatrix):
        return ParCSRMatrix(strength(a.global_csr, strength_type, theta,
                                     num_variables, variables),
                            a.partition)
    if strength_type == StrengthType.Classical:
        return classical_strength(a, theta, num_variables, variables)
    return symmetric_strength(a, theta)
