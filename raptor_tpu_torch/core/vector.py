"""Distributed vector, host-side description (copy of
raptor_tpu.core.vector).

Equivalent of the reference's ``ParVector`` (core/par_vector.hpp:44-176): a
global vector and its row partition. Norms and inner products are global
reductions (par_vector.cpp:88,101); on the device they are the sums over
shards of ``device.par.norm`` / ``shard_dots``.
"""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch.core.partition import Partition


class ParVector:
    def __init__(self, values: np.ndarray, partition: Partition):
        self.values = np.asarray(values, dtype=np.float64)
        self.partition = partition

    @staticmethod
    def zeros(partition: Partition) -> "ParVector":
        return ParVector(np.zeros(partition.global_num_rows), partition)

    def norm(self, p: int = 2) -> float:
        if p == 2:
            return float(np.linalg.norm(self.values))
        return float(np.sum(np.abs(self.values) ** p) ** (1.0 / p))

    def inner_product(self, other: "ParVector") -> float:
        return float(self.values @ other.values)

    def copy(self) -> "ParVector":
        return ParVector(self.values.copy(), self.partition)

    # the reference's Vector operations (core/vector.cpp)
    def set_const_value(self, alpha: float) -> "ParVector":
        self.values[:] = alpha
        return self

    def axpy(self, other: "ParVector", alpha: float) -> "ParVector":
        """self += alpha * other (core/vector.cpp axpy)."""
        self.values += alpha * other.values
        return self

    def scale(self, alpha: float) -> "ParVector":
        self.values *= alpha
        return self

    @property
    def local(self) -> np.ndarray:
        """The whole vector: this host-side description holds every row;
        shard s's rows are ``local_slice(s)``."""
        return self.values

    def local_slice(self, s: int) -> np.ndarray:
        b = self.partition.row_bounds
        return self.values[int(b[s]):int(b[s + 1])]
