"""Library-wide types, enums, and constants (copy of raptor_tpu.core.types).

Mirrors the option surface of the reference's core/types.hpp:24-75 as Python
enums.
"""

import enum

# Drop tolerance applied when assembling / multiplying sparse matrices
# (reference: core/types.hpp:24).
ZERO_TOL = 1e-16


class StrengthType(enum.Enum):
    Classical = 0
    Symmetric = 1


class CoarsenType(enum.Enum):
    RS = 0
    CLJP = 1
    Falgout = 2
    PMIS = 3
    HMIS = 4


class InterpType(enum.Enum):
    Direct = 0
    ModClassical = 1
    Extended = 2


class AggType(enum.Enum):
    MIS = 0


class ProlongType(enum.Enum):
    JacobiProlongation = 0


class RelaxType(enum.Enum):
    Jacobi = 0
    SOR = 1
    SSOR = 2
    MCSOR = 3
    MCSSOR = 4
    L1Jacobi = 5
    Chebyshev = 6


# CF-splitting state constants (reference: core/types.hpp:29-35).
class CFState:
    TmpSelection = 4
    NewSelection = 3
    NewUnselection = 2
    Selected = 1
    Unselected = 0
    Unassigned = -1
    NoNeighbors = -2
