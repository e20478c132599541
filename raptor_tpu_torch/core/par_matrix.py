"""Row-partitioned distributed matrix, host-side description (copy of
raptor_tpu.core.par_matrix: ``ParCSRMatrix`` and ``ShardBlocks`` only).

Equivalent of the reference's ``ParCSRMatrix`` (core/par_matrix.hpp:78-849):
each shard owns a contiguous block of rows split into an ``on_proc`` block
(columns owned by the shard) and a condensed ``off_proc`` halo block with an
``off_proc_column_map`` of global column ids (``condense_off_proc``,
par_matrix.cpp:79-112). The global CSR + a ``Partition`` is the canonical
storage; the per-shard blocks are derived once and cached.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.partition import Partition


@dataclasses.dataclass
class ShardBlocks:
    """One shard's row block, split like the reference ParMatrix."""

    on_proc: CSRMatrix              # local rows x local cols
    off_proc: CSRMatrix             # local rows x n_halo (condensed)
    off_proc_column_map: np.ndarray  # [n_halo] global col ids, sorted
    first_local_row: int
    first_local_col: int

    @property
    def local_num_rows(self) -> int:
        return self.on_proc.n_rows

    @property
    def on_proc_num_cols(self) -> int:
        return self.on_proc.n_cols


class ParCSRMatrix:
    """1-D row-partitioned matrix over ``n_shards``: the global CSR is
    canonical and the per-shard on/off blocks are derived views."""

    def __init__(self, global_csr: CSRMatrix, partition: Partition):
        if (global_csr.n_rows != partition.global_num_rows
                or global_csr.n_cols != partition.global_num_cols):
            raise ValueError(
                f"matrix shape {global_csr.shape} does not match partition "
                f"({partition.global_num_rows}, "
                f"{partition.global_num_cols})")
        self.global_csr = global_csr
        self.partition = partition
        self._shards: Optional[List[ShardBlocks]] = None

    @property
    def global_num_rows(self) -> int:
        return self.partition.global_num_rows

    @property
    def global_num_cols(self) -> int:
        return self.partition.global_num_cols

    @property
    def n_shards(self) -> int:
        return self.partition.n_shards

    @property
    def nnz(self) -> int:
        return self.global_csr.nnz

    def copy(self) -> "ParCSRMatrix":
        return ParCSRMatrix(self.global_csr.copy(), self.partition)

    def shards(self) -> List[ShardBlocks]:
        """Split into per-shard (on_proc, off_proc) blocks with condensed halo
        column maps (finalize()/condense_off_proc semantics,
        par_matrix.cpp:79-162)."""
        if self._shards is not None:
            return self._shards
        out = []
        part = self.partition
        for s in range(part.n_shards):
            r0, r1 = part.row_bounds[s], part.row_bounds[s + 1]
            c0, c1 = part.col_bounds[s], part.col_bounds[s + 1]
            rows = self.global_csr.row_slice(int(r0), int(r1))
            on_mask_csr = rows.col_slice(int(c0), int(c1))
            rows_sp = rows.to_scipy().tocoo()
            off_sel = (rows_sp.col < c0) | (rows_sp.col >= c1)
            off_gcols = rows_sp.col[off_sel]
            col_map = np.unique(off_gcols)
            cond = np.searchsorted(col_map, off_gcols)
            off = sp.csr_matrix(
                (rows_sp.data[off_sel], (rows_sp.row[off_sel], cond)),
                shape=(int(r1 - r0), len(col_map)))
            off.sum_duplicates()
            off.sort_indices()
            out.append(ShardBlocks(
                on_proc=on_mask_csr.canonicalize(),
                off_proc=CSRMatrix.from_scipy(off),
                off_proc_column_map=col_map.astype(np.int64),
                first_local_row=int(r0),
                first_local_col=int(c0),
            ))
        self._shards = out
        return out

    def mult(self, x: np.ndarray) -> np.ndarray:
        """b = A x (par_spmv.cpp:25-59), host reference."""
        return self.global_csr.mult(x)

    def multiply(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        """C = A B (par_matmult.cpp:79-113); A's rows, B's cols."""
        c = self.global_csr.multiply(other.global_csr)
        return ParCSRMatrix(c, self.partition.product(other.partition))

    def mult_T_mat(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        """C = self^T @ other (AP->mult_T(P), par_matmult.cpp:163)."""
        c = self.global_csr.T_multiply(other.global_csr)
        return ParCSRMatrix(
            c, self.partition.transpose().product(other.partition))

    def transpose(self) -> "ParCSRMatrix":
        """Distributed transpose (par_matrix.cpp:694-858)."""
        return ParCSRMatrix(self.global_csr.transpose(),
                            self.partition.transpose())
