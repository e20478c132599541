"""Row-partitioned distributed matrices, host-side description (copy of
raptor_tpu.core.par_matrix).

Equivalent of the reference's ``ParCSRMatrix`` (core/par_matrix.hpp:78-849):
each shard owns a contiguous block of rows split into an ``on_proc`` block
(columns owned by the shard) and a condensed ``off_proc`` halo block with an
``off_proc_column_map`` of global column ids (``condense_off_proc``,
par_matrix.cpp:79-112). In-process, the global CSR + a ``Partition`` is the
canonical storage and the per-shard blocks are derived once and cached; a
local view (``from_shard_blocks`` / ``from_local_rows``) holds only shard
blocks, as the distributed setup (``ruge_stuben.par_setup``) builds them.
Beside it: the assembly containers ``ParCOOMatrix`` and ``ParBCOOMatrix``,
the column views ``ParCSCMatrix`` and ``ParBSCMatrix``, and the blocked
``ParBSRMatrix`` (core/par_matrix.hpp:345-792).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import (
    BCOOMatrix, BSCMatrix, BSRMatrix, CSCMatrix, CSRMatrix)
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
        if self.global_csr is None:
            return ParCSRMatrix.from_shard_blocks(
                list(self._shards), self.partition, self.first_shard)
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

    def mult_T(self, x: np.ndarray) -> np.ndarray:
        """b = A^T x (par_spmv.cpp:157-209), host reference."""
        return self._g().mult_T(x)

    def residual(self, x: np.ndarray, b: np.ndarray) -> np.ndarray:
        return self._g().residual(x, b)

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

    def add(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        return ParCSRMatrix(self._g().add(other._g()), self.partition)

    def subtract(self, other: "ParCSRMatrix") -> "ParCSRMatrix":
        return ParCSRMatrix(self._g().subtract(other._g()), self.partition)

    def diagonal(self) -> np.ndarray:
        return self._g().diagonal()


def par_matrix_from_scipy(m, n_shards: int) -> ParCSRMatrix:
    """A scipy matrix over the contiguous block partition into
    ``n_shards``."""
    csr = CSRMatrix.from_scipy(m)
    return ParCSRMatrix(
        csr, Partition.create(csr.n_rows, csr.n_cols, n_shards))


class ParCOOMatrix:
    """Row-partitioned COO (core/par_matrix.hpp:345-423), the assembly
    format: ``add_global_value`` / ``add_values`` gather triplets, in
    numpy chunks, and ``finalize`` converts them to a ParCSR with the
    duplicates summed in the order they were added (finalize(),
    par_matrix.cpp:114-162)."""

    def __init__(self, partition: Partition):
        self.partition = partition
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []

    def add_global_value(self, row: int, col: int, val: float) -> None:
        self.add_values([row], [col], [val])

    def add_values(self, rows, cols, vals) -> None:
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        vals = np.asarray(vals, dtype=np.float64).ravel()
        if not len(rows) == len(cols) == len(vals):
            raise ValueError(f"{len(rows)} rows, {len(cols)} columns and "
                             f"{len(vals)} values")
        self._rows.append(rows)
        self._cols.append(cols)
        self._vals.append(vals)

    def finalize(self) -> ParCSRMatrix:
        part = self.partition

        def cat(chunks, dtype):
            return (np.concatenate(chunks) if chunks
                    else np.zeros(0, dtype=dtype))

        g = sp.csr_matrix(
            (cat(self._vals, np.float64),
             (cat(self._rows, np.int64), cat(self._cols, np.int64))),
            shape=(part.global_num_rows, part.global_num_cols))
        g.sum_duplicates()
        g.sort_indices()
        return ParCSRMatrix(CSRMatrix.from_scipy(g), part)


class ParCSCMatrix:
    """Column-compressed view of a row-partitioned matrix
    (core/par_matrix.hpp:701-790), for column-driven setup passes. On an
    in-process ParCSR it holds one global CSC; on a local view, a CSC
    block of each local shard's rows (global column ids), as each rank of
    the reference compresses only its own rows."""

    def __init__(self, par_csr: ParCSRMatrix):
        self.partition = par_csr.partition
        self.par_csr = par_csr
        if par_csr.is_local_view:
            self.csc = None
            G = self.partition.global_num_cols
            self._local_cscs = [CSCMatrix.from_csr(blk.global_cols_csr(G))
                                for blk in par_csr.shards()]
        else:
            self.csc = CSCMatrix.from_csr(par_csr._g())
            self._local_cscs = None

    def local_csc(self, i: int) -> CSCMatrix:
        """The i-th LOCAL shard's rows as a CSC block (global columns)."""
        if self._local_cscs is not None:
            return self._local_cscs[i]
        G = self.partition.global_num_cols
        return CSCMatrix.from_csr(
            self.par_csr.shards()[i].global_cols_csr(G))

    def to_par_csr(self) -> ParCSRMatrix:
        if self.csc is None:
            return ParCSRMatrix.from_local_rows(
                [c.to_csr() for c in self._local_cscs], self.partition,
                first_shard=self.par_csr.first_shard)
        return ParCSRMatrix(self.csc.to_csr(), self.partition)

    def transpose(self, tr=None) -> ParCSRMatrix:
        """A^T, row-partitioned by A's columns. On a local view, the
        distributed transpose over the transport ``tr`` (in-process by
        default; core/par_matrix.cpp:694-858): no global matrix on any
        rank."""
        if self.csc is None:
            from raptor_tpu_torch.ruge_stuben.par_setup import dist_transpose
            t_blocks = dist_transpose(self.par_csr, tr, assemble=False)
            return ParCSRMatrix.from_local_rows(
                t_blocks, self.partition.transpose(),
                first_shard=self.par_csr.first_shard)
        return ParCSRMatrix(self.csc.transpose(), self.partition.transpose())


class ParBSRMatrix:
    """Row-partitioned blocked matrix (core/par_matrix.hpp:613-699): a
    scalar ParCSR re-partitioned on block boundaries, with the block size.
    On a local view the rows move to their block-aligned owners through
    the transport's row-routed reduction (``reduce_rows``; the CSR -> BSR
    redistribution, par_matrix.cpp:872-997), so no rank ever holds the
    global matrix. ``to_device`` packs the block-ELL device matrix
    (``device.bsr.device_put_bsr``)."""

    def __init__(self, par_csr: ParCSRMatrix, b_rows: int,
                 b_cols: Optional[int] = None, tr=None):
        b_cols = b_cols or b_rows
        if (par_csr.global_num_rows % b_rows
                or par_csr.global_num_cols % b_cols):
            raise ValueError(
                f"{par_csr.global_num_rows} x {par_csr.global_num_cols} "
                f"matrix is not made of {b_rows} x {b_cols} blocks")
        self.b_rows, self.b_cols = int(b_rows), int(b_cols)
        from raptor_tpu_torch.multilevel.bsr_hierarchy import block_partition
        part = block_partition(par_csr.global_num_rows,
                               par_csr.global_num_cols, b_rows,
                               par_csr.partition.n_shards)
        if par_csr.is_local_view:
            from raptor_tpu_torch.comm.transport import InProcessTransport
            tr = tr or InProcessTransport(par_csr)
            G = part.global_num_cols
            triplets = []
            for blk in par_csr.shards():
                g = blk.global_cols_csr(G)
                rows = g.row_ids() + blk.first_local_row
                triplets.append((rows.astype(np.int64), g.indices.copy(),
                                 g.data))
            blocks = tr.reduce_rows(triplets, part.row_bounds, G)
            self.par_csr = ParCSRMatrix.from_local_rows(
                blocks, part, first_shard=getattr(tr, "first_shard",
                                                  par_csr.first_shard))
        else:
            self.par_csr = ParCSRMatrix(par_csr._g(), part)

    @property
    def partition(self) -> Partition:
        return self.par_csr.partition

    @property
    def global_num_rows(self) -> int:
        return self.par_csr.global_num_rows

    def local_bsr(self, s: int) -> BSRMatrix:
        """Shard s's rows as a serial BSRMatrix (global block columns); a
        local view converts only its own row blocks (``s`` counts from
        shard 0, not from ``first_shard``)."""
        part = self.par_csr.partition
        r0 = int(part.row_bounds[s])
        r1 = int(part.row_bounds[s + 1])
        G = self.par_csr.global_num_cols
        if self.par_csr.is_local_view:
            blk = self.par_csr.shards()[s - self.par_csr.first_shard]
            g = blk.global_cols_csr(G).to_scipy()
        else:
            g = self.par_csr._g().to_scipy()[r0:r1]
        gb = g.tobsr(blocksize=(self.b_rows, self.b_cols))
        return BSRMatrix(r1 - r0, G, self.b_rows, self.b_cols,
                         gb.indptr.astype(np.int64),
                         gb.indices.astype(np.int64), np.asarray(gb.data))

    def to_device(self, device="cuda", dtype=None):
        """The block-ELL device matrix (``device_put_bsr``, float64 by
        default); ``device`` defaults to CUDA and raises when it is
        absent."""
        import torch

        from raptor_tpu_torch.device.bsr import device_put_bsr
        return device_put_bsr(self.par_csr, self.b_rows, self.b_cols,
                              dtype=dtype or torch.float64, device=device)

    def mult(self, x: np.ndarray) -> np.ndarray:
        return self.par_csr.mult(x)


class ParBCOOMatrix:
    """Row-partitioned blocked COO (core/par_matrix.hpp:424), the blocked
    assembly container: ``add_block`` gathers b_rows x b_cols dense blocks
    at global block coordinates, and ``finalize`` sums the duplicates
    (``BCOOMatrix.to_bsr``) and gives a ParBSR (the add_value block path,
    par_matrix.cpp:26-78, and finalize :114-162)."""

    def __init__(self, partition: Partition, b_rows: int,
                 b_cols: Optional[int] = None):
        b_cols = b_cols or b_rows
        if (partition.global_num_rows % b_rows
                or partition.global_num_cols % b_cols):
            raise ValueError(
                f"{partition.global_num_rows} x {partition.global_num_cols}"
                f" partition is not made of {b_rows} x {b_cols} blocks")
        self.partition = partition
        self.b_rows, self.b_cols = int(b_rows), int(b_cols)
        self._rows: List[int] = []   # global block rows
        self._cols: List[int] = []   # global block cols
        self._blocks: List[np.ndarray] = []

    def add_block(self, brow: int, bcol: int, block) -> None:
        block = np.asarray(block, dtype=np.float64)
        if block.shape != (self.b_rows, self.b_cols):
            raise ValueError(f"a {block.shape} block, not "
                             f"{(self.b_rows, self.b_cols)}")
        self._rows.append(int(brow))
        self._cols.append(int(bcol))
        self._blocks.append(block)

    def finalize(self) -> ParBSRMatrix:
        part = self.partition
        coo = BCOOMatrix(part.global_num_rows, part.global_num_cols,
                         self.b_rows, self.b_cols,
                         np.asarray(self._rows, dtype=np.int64),
                         np.asarray(self._cols, dtype=np.int64),
                         np.asarray(self._blocks, dtype=np.float64)
                         if self._blocks else
                         np.zeros((0, self.b_rows, self.b_cols)))
        g = coo.to_bsr().to_scipy().tocsr()
        g.sum_duplicates()
        g.sort_indices()
        return ParBSRMatrix(ParCSRMatrix(CSRMatrix.from_scipy(g), part),
                            self.b_rows, self.b_cols)


class ParBSCMatrix:
    """Blocked column-compressed view of a row-partitioned blocked matrix
    (core/par_matrix.hpp:792): each shard's BSC block, for column-driven
    setup passes, as ParCSCMatrix at the block level."""

    def __init__(self, par_bsr: ParBSRMatrix):
        self.par_bsr = par_bsr
        self.partition = par_bsr.partition

    def local_bsc(self, s: int) -> BSCMatrix:
        """Shard s's rows as a serial BSCMatrix (global block columns)."""
        return BSCMatrix.from_bsr(self.par_bsr.local_bsr(s))

    def to_par_bsr(self) -> ParBSRMatrix:
        return self.par_bsr
