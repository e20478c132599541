"""Row-partitioned distributed matrix, host-side description (copy of
raptor_tpu.core.par_matrix: ``ParCSRMatrix``, ``ShardBlocks``,
``shard_from_local_rows`` and ``par_matrix_from_scipy`` only).

Equivalent of the reference's ``ParCSRMatrix`` (core/par_matrix.hpp:78-849):
each shard owns a contiguous block of rows split into an ``on_proc`` block
(columns owned by the shard) and a condensed ``off_proc`` halo block with an
``off_proc_column_map`` of global column ids (``condense_off_proc``,
par_matrix.cpp:79-112). In-process, the global CSR + a ``Partition`` is the
canonical storage and the per-shard blocks are derived once and cached; a
local view (``from_shard_blocks`` / ``from_local_rows``) holds only shard
blocks, as the distributed setup (``ruge_stuben.par_setup``) builds them.
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

    @property
    def nnz(self) -> int:
        return self.on_proc.nnz + self.off_proc.nnz

    def global_cols_csr(self, n_global_cols: int) -> CSRMatrix:
        """This shard's rows as one CSR over GLOBAL column ids (the
        reference's init_par_mat_comm flattening, comm_mat.cpp:57-92): the
        wire format of matrix-row communication. Cached."""
        cached = getattr(self, "_gcols_csr", None)
        if cached is not None and cached.n_cols == n_global_cols:
            return cached
        on, off = self.on_proc, self.off_proc
        c0 = self.first_local_col
        cmap = np.asarray(self.off_proc_column_map)
        rows = np.concatenate([on.row_ids(), off.row_ids()])
        cols = np.concatenate([on.indices.astype(np.int64) + c0,
                               cmap[off.indices] if off.nnz
                               else np.zeros(0, dtype=np.int64)])
        vals = np.concatenate([on.data, off.data])
        g = sp.csr_matrix((vals, (rows, cols)),
                          shape=(on.n_rows, n_global_cols))
        g.sort_indices()
        self._gcols_csr = CSRMatrix.from_scipy(g)
        return self._gcols_csr


def shard_from_local_rows(local: CSRMatrix, first_row: int,
                          c0: int, c1: int) -> ShardBlocks:
    """One shard's (on_proc, off_proc) split from its local row block
    stored with GLOBAL column ids (finalize()/condense_off_proc,
    par_matrix.cpp:79-162): a shard built from its own rows only."""
    coo = local.to_scipy().tocoo()
    on_sel = (coo.col >= c0) & (coo.col < c1)
    on = sp.csr_matrix(
        (coo.data[on_sel], (coo.row[on_sel], coo.col[on_sel] - c0)),
        shape=(local.n_rows, c1 - c0))
    on.sum_duplicates()
    on.sort_indices()
    off_sel = ~on_sel
    off_gcols = coo.col[off_sel]
    col_map = np.unique(off_gcols)
    cond = np.searchsorted(col_map, off_gcols)
    off = sp.csr_matrix(
        (coo.data[off_sel], (coo.row[off_sel], cond)),
        shape=(local.n_rows, len(col_map)))
    off.sum_duplicates()
    off.sort_indices()
    return ShardBlocks(
        on_proc=CSRMatrix.from_scipy(on),
        off_proc=CSRMatrix.from_scipy(off),
        off_proc_column_map=col_map.astype(np.int64),
        first_local_row=int(first_row),
        first_local_col=int(c0))


class ParCSRMatrix:
    """1-D row-partitioned matrix over ``n_shards``, in one of two modes:
    in-process (``__init__``), where the global CSR is canonical and the
    per-shard on/off blocks are derived views, or a local view
    (``from_shard_blocks`` / ``from_local_rows``), which holds only the
    shard blocks of ``first_shard`` onward and no global CSR; its
    global-matrix methods raise."""

    def __init__(self, global_csr: CSRMatrix, partition: Partition):
        if (global_csr.n_rows != partition.global_num_rows
                or global_csr.n_cols != partition.global_num_cols):
            raise ValueError(
                f"matrix shape {global_csr.shape} does not match partition "
                f"({partition.global_num_rows}, "
                f"{partition.global_num_cols})")
        self.global_csr = global_csr
        self.partition = partition
        self.first_shard = 0
        self._shards: Optional[List[ShardBlocks]] = None

    @classmethod
    def from_shard_blocks(cls, blocks: List[ShardBlocks],
                          partition: Partition,
                          first_shard: int = 0) -> "ParCSRMatrix":
        """Local view from shard blocks (a contiguous shard range starting
        at ``first_shard``). No global CSR exists."""
        self = cls.__new__(cls)
        self.global_csr = None
        self.partition = partition
        self.first_shard = int(first_shard)
        self._shards = list(blocks)
        return self

    @classmethod
    def from_local_rows(cls, local_rows: List[CSRMatrix],
                        partition: Partition,
                        first_shard: int = 0) -> "ParCSRMatrix":
        """Local view from per-shard row blocks stored with GLOBAL column
        ids (what matrix-row communication produces)."""
        blocks = []
        for i, loc in enumerate(local_rows):
            s = first_shard + i
            blocks.append(shard_from_local_rows(
                loc, int(partition.row_bounds[s]),
                int(partition.col_bounds[s]),
                int(partition.col_bounds[s + 1])))
        return cls.from_shard_blocks(blocks, partition, first_shard)

    @property
    def is_local_view(self) -> bool:
        return self.global_csr is None

    def _g(self) -> CSRMatrix:
        if self.global_csr is None:
            raise RuntimeError(
                "local-view ParCSRMatrix: it holds no global matrix; use "
                "its shard blocks, or assemble_global() when it holds "
                "every shard")
        return self.global_csr

    def assemble_global(self) -> CSRMatrix:
        """The global CSR of a view that holds every shard."""
        if self.global_csr is not None:
            return self.global_csr
        if self.first_shard != 0 or (len(self._shards)
                                     != self.partition.n_shards):
            raise RuntimeError("assemble_global needs every shard")
        n_cols = self.partition.global_num_cols
        g = sp.vstack([blk.global_cols_csr(n_cols).to_scipy()
                       for blk in self._shards]).tocsr()
        g.sort_indices()
        return CSRMatrix.from_scipy(g)

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
        return self._g().nnz

    @property
    def local_nnz(self) -> int:
        """nnz of the shards this matrix holds."""
        return sum(blk.nnz for blk in self.shards())

    def copy(self) -> "ParCSRMatrix":
        return ParCSRMatrix(self._g().copy(), self.partition)

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
            rows = self._g().row_slice(int(r0), int(r1))
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
        return self._g().mult(x)

    def multiply(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        """C = A B (par_matmult.cpp:79-113); A's rows, B's cols."""
        c = self._g().multiply(other._g())
        return ParCSRMatrix(c, self.partition.product(other.partition))

    def mult_T_mat(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        """C = self^T @ other (AP->mult_T(P), par_matmult.cpp:163)."""
        c = self._g().T_multiply(other._g())
        return ParCSRMatrix(
            c, self.partition.transpose().product(other.partition))

    def transpose(self) -> "ParCSRMatrix":
        """Distributed transpose (par_matrix.cpp:694-858)."""
        return ParCSRMatrix(self._g().transpose(),
                            self.partition.transpose())

    def diagonal(self) -> np.ndarray:
        return self._g().diagonal()


def par_matrix_from_scipy(m, n_shards: int) -> ParCSRMatrix:
    """A scipy matrix over the contiguous block partition into
    ``n_shards``."""
    csr = CSRMatrix.from_scipy(m)
    return ParCSRMatrix(
        csr, Partition.create(csr.n_rows, csr.n_cols, n_shards))
