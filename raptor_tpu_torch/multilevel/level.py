"""One level of an AMG hierarchy, host side (copy of
raptor_tpu.multilevel.level; ParLevel, multilevel/par_level.hpp:15-43)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from raptor_tpu_torch.core.par_matrix import ParCSRMatrix


@dataclasses.dataclass
class Level:
    A: ParCSRMatrix
    P: Optional[ParCSRMatrix] = None
