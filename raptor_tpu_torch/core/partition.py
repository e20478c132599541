"""1-D contiguous block row/col partitions (copy of raptor_tpu.core.partition).

Equivalent of the reference's ``Partition`` (core/partition.hpp:36-344): the
host computes the full table of shard boundaries once, and the "assumed
partition" owner lookup collapses to a ``searchsorted`` on that table.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _block_bounds(n: int, parts: int) -> np.ndarray:
    """Boundary offsets of splitting ``n`` items into ``parts`` contiguous
    blocks; the first ``n % parts`` blocks get one extra item
    (reference rule: core/partition.hpp:53-65)."""
    avg, extra = divmod(n, parts)
    sizes = np.full(parts, avg, dtype=np.int64)
    sizes[:extra] += 1
    bounds = np.zeros(parts + 1, dtype=np.int64)
    np.cumsum(sizes, out=bounds[1:])
    return bounds


@dataclasses.dataclass(frozen=True)
class Partition:
    """Contiguous 1-D partition of ``global_num_rows`` x ``global_num_cols``
    over ``n_shards`` row shards."""

    global_num_rows: int
    global_num_cols: int
    n_shards: int
    row_bounds: np.ndarray  # [n_shards+1]
    col_bounds: np.ndarray  # [n_shards+1]

    @staticmethod
    def create(global_num_rows: int, global_num_cols: int,
               n_shards: int) -> "Partition":
        row_bounds = _block_bounds(global_num_rows, n_shards)
        # Reference quirk: cols are partitioned over min(n_shards, n_rows)
        # procs, ranks with no rows get no cols (core/partition.hpp:68-92).
        eff = min(n_shards, global_num_rows) if global_num_rows else n_shards
        col_bounds = np.zeros(n_shards + 1, dtype=np.int64)
        if eff > 0:
            cb = _block_bounds(global_num_cols, eff)
            col_bounds[1:eff + 1] = cb[1:]
            col_bounds[eff + 1:] = global_num_cols
        return Partition(global_num_rows, global_num_cols, n_shards,
                         row_bounds, col_bounds)

    @property
    def max_local_rows(self) -> int:
        return int(np.max(np.diff(self.row_bounds)))

    @property
    def max_local_cols(self) -> int:
        return int(np.max(np.diff(self.col_bounds)))

    def col_owner(self, global_cols: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.col_bounds[:max(1, self.n_shards) + 1],
                               np.asarray(global_cols), side="right") - 1

    def transpose(self) -> "Partition":
        """Partition of the transposed matrix (core/partition.hpp:265-270)."""
        return Partition(self.global_num_cols, self.global_num_rows,
                         self.n_shards, self.col_bounds, self.row_bounds)

    def product(self, other: "Partition") -> "Partition":
        """Partition of A@B: A's rows, B's cols (core/partition.hpp:241-263)."""
        return Partition(self.global_num_rows, other.global_num_cols,
                         self.n_shards, self.row_bounds, other.col_bounds)
