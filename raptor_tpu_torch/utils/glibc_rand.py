"""Deterministic CF-splitting weights from glibc's ``rand()`` (copy of
raptor_tpu.utils.glibc_rand, native path only).

The reference seeds C ``rand()`` with ``srand(2448422 + first_local_row)``
(multilevel/par_multilevel.hpp:209-219); reproducing those weights
bit-exactly keeps hierarchies identical to the reference's.
"""

from __future__ import annotations

import numpy as np


def form_rand_weights(local_n: int, first_n: int) -> np.ndarray:
    """form_rand_weights (par_multilevel.hpp:209-219)."""
    from raptor_tpu_torch import native
    return native.glibc_rand_doubles(2448422 + first_n, local_n)
