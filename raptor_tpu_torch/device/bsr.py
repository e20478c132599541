"""Blocked (BSR) stacked-shard device matrix (copy of raptor_tpu.device.bsr).

Equivalent of the reference's ParBSRMatrix path (core/par_matrix.hpp:613,
BSR SpMV util/linalg/spmv.cpp:128): the matrix is partitioned over *block
rows*, the halo exchange ships whole block-column vectors, and the block
product is a batched small matrix-vector product over [W, RB, br, bc]
blocks. The JAX package computes it as an XLA einsum outside any Pallas
kernel; here it is a multiply and a sum of torch ops. As in
``device.par``, every array keeps the leading shard axis ``S`` on one
device and the shard code is batched over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from raptor_tpu_torch.comm.plan import build_comm_plan
from raptor_tpu_torch.core.matrix import BSRMatrix, CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.partition import Partition
from raptor_tpu_torch.device.par import resolve_device


@dataclasses.dataclass
class DeviceParBSR:
    on_cols: torch.Tensor     # [S, W_on, RB] int64 block col ids
    on_blocks: torch.Tensor   # [S, W_on, RB, br, bc]
    # off block compacted to the BB boundary block rows (see device.par)
    off_rows: torch.Tensor    # [S, BB] int64 block row ids (pad = RB)
    off_cols: torch.Tensor    # [S, W_off, BB] int64 halo block ids
    off_blocks: torch.Tensor  # [S, W_off, BB, br, bc]
    send_idx: torch.Tensor    # [S, S, Q] int64 local block col ids
    send_mask: torch.Tensor
    halo_src: torch.Tensor    # [S, Hb] int64 flat recv slot
    slot_to_halo: torch.Tensor
    recv_mask: torch.Tensor
    row_mask: torch.Tensor    # [S, RB]
    b_rows: int
    b_cols: int
    brows_pad: int            # padded block rows per shard
    bcols_pad: int
    halo_pad: int
    slot: int
    global_num_rows: int      # scalar rows
    global_num_cols: int

    @property
    def n_shards(self) -> int:
        return self.on_cols.shape[0]


def _block_ell(a: BSRMatrix, rb_pad: int, width: int):
    cols = np.zeros((width, rb_pad), dtype=np.int32)
    blocks = np.zeros((width, rb_pad, a.b_rows, a.b_cols))
    nbr = a.n_block_rows
    row_nnz = np.diff(a.indptr)
    if len(a.indices):
        rows = np.repeat(np.arange(nbr), row_nnz)
        pos = np.arange(len(a.indices)) - np.repeat(a.indptr[:-1], row_nnz)
        cols[pos, rows] = a.indices
        blocks[pos, rows] = a.blocks
    return cols, blocks


def device_put_bsr(a: ParCSRMatrix, b_rows: int, b_cols: int,
                   dtype=torch.float64, device="cuda") -> DeviceParBSR:
    """Build a blocked device matrix from a scalar ParCSRMatrix
    (to_ParBSR equivalent, core/par_matrix.cpp:872-997). The row partition
    is re-formed on block-row boundaries. ``device`` defaults to CUDA and
    raises when CUDA is absent."""
    dev = resolve_device(device)
    n, m = a.global_num_rows, a.global_num_cols
    if n % b_rows or m % b_cols:
        raise ValueError(f"{n} x {m} matrix is not made of {b_rows} x "
                         f"{b_cols} blocks")
    S = a.partition.n_shards
    # block-level partition (contiguous block rows)
    bpart = Partition.create(n // b_rows, m // b_cols, S)
    part = Partition(n, m, S, bpart.row_bounds * b_rows,
                     bpart.col_bounds * b_cols)
    g = a.global_csr.to_scipy()

    # block-level sparsity pattern for the comm plan
    gb = g.tobsr(blocksize=(b_rows, b_cols))
    pat = sp.csr_matrix(
        (np.ones(len(gb.indices)), gb.indices, gb.indptr),
        shape=(n // b_rows, m // b_cols))
    bpat = ParCSRMatrix(CSRMatrix.from_scipy(pat), bpart)
    plan = build_comm_plan(bpat)
    shards = bpat.shards()

    RB = max(1, bpart.max_local_rows)
    W_on = max(1, max((int(np.diff(s.on_proc.indptr).max())
                       if s.on_proc.nnz else 0) for s in shards))
    W_off = max((int(np.diff(s.off_proc.indptr).max())
                 if s.off_proc.nnz else 0) for s in shards)
    BB = max(int(np.count_nonzero(np.diff(s.off_proc.indptr)))
             for s in shards)

    on_cols = np.zeros((S, W_on, RB), dtype=np.int32)
    on_blocks = np.zeros((S, W_on, RB, b_rows, b_cols))
    off_rows = np.full((S, BB), RB, dtype=np.int32)
    off_cols = np.zeros((S, W_off, BB), dtype=np.int32)
    off_blocks = np.zeros((S, W_off, BB, b_rows, b_cols))
    row_mask = np.zeros((S, RB))

    for s in range(S):
        r0, r1 = int(part.row_bounds[s]), int(part.row_bounds[s + 1])
        c0, c1 = int(part.col_bounds[s]), int(part.col_bounds[s + 1])
        rows = g[r0:r1].tobsr(blocksize=(b_rows, b_cols))
        bcols = rows.indices
        on_sel = ((bcols * b_cols >= c0) & (bcols * b_cols < c1))
        onb = BSRMatrix(r1 - r0, c1 - c0, b_rows, b_cols,
                        _reindptr(rows.indptr, on_sel),
                        bcols[on_sel] - c0 // b_cols,
                        np.asarray(rows.data)[on_sel])
        # off_proc block, condensed against the plan's halo column map
        cmap = shards[s].off_proc_column_map
        offb_cols = np.searchsorted(cmap, bcols[~on_sel])
        offb = BSRMatrix(r1 - r0, len(cmap) * b_cols, b_rows, b_cols,
                         _reindptr(rows.indptr, ~on_sel), offb_cols,
                         np.asarray(rows.data)[~on_sel])
        on_cols[s], on_blocks[s] = _block_ell(onb, RB, W_on)
        if BB:
            (off_rows[s, :], off_cols[s],
             off_blocks[s]) = _block_ell_boundary(offb, W_off, BB, RB)
        row_mask[s, :(r1 - r0) // b_rows] = 1.0

    def put(x, dt):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

    lng = torch.int64
    return DeviceParBSR(
        on_cols=put(on_cols, lng), on_blocks=put(on_blocks, dtype),
        off_rows=put(off_rows, lng), off_cols=put(off_cols, lng),
        off_blocks=put(off_blocks, dtype),
        send_idx=put(plan.send_idx, lng),
        send_mask=put(plan.send_mask, dtype),
        halo_src=put(plan.halo_src, lng),
        slot_to_halo=put(plan.slot_to_halo, lng),
        recv_mask=put(plan.recv_mask, dtype), row_mask=put(row_mask, dtype),
        b_rows=b_rows, b_cols=b_cols, brows_pad=RB,
        bcols_pad=max(1, bpart.max_local_cols), halo_pad=plan.halo_pad,
        slot=plan.slot, global_num_rows=n, global_num_cols=m)


def _block_ell_boundary(a: BSRMatrix, width: int, bb: int, rb_pad: int):
    """Boundary-compacted block ELL: only block rows with halo entries."""
    rows = np.full(bb, rb_pad, dtype=np.int32)
    cols = np.zeros((width, bb), dtype=np.int32)
    blocks = np.zeros((width, bb, a.b_rows, a.b_cols))
    row_nnz = np.diff(a.indptr)
    brows = np.nonzero(row_nnz)[0]
    if len(brows):
        rows[:len(brows)] = brows
        bn = row_nnz[brows]
        rpos = np.repeat(np.arange(len(brows)), bn)
        pos = np.arange(len(a.indices)) - np.repeat(a.indptr[brows], bn)
        cols[pos, rpos] = a.indices
        blocks[pos, rpos] = a.blocks
    return rows, cols, blocks


def _reindptr(indptr, sel):
    nrows = len(indptr) - 1
    rows = np.repeat(np.arange(nrows), np.diff(indptr))
    counts = np.bincount(rows[sel], minlength=nrows)
    out = np.zeros(len(indptr), dtype=np.int64)
    np.cumsum(counts, out=out[1:])
    return out


# --- shard-batched operators ---------------------------------------------------

def _block_take(x2: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather of block vectors: ``out[s, ...] = x2[s, idx[s,
    ...]]``; x2 [S, N, bc] -> [*idx.shape, bc]."""
    S = x2.shape[0]
    shard = torch.arange(S, device=x2.device).reshape((S,) + (1,) *
                                                      (idx.dim() - 1))
    return x2[shard, idx]


def block_product(blocks: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """out[s, r, i] = sum_w sum_j blocks[s, w, r, i, j] * xg[s, w, r, j]:
    the batched block product (JAX's einsum "wrij,wrj->ri" on each
    shard)."""
    return (blocks * xg.unsqueeze(-2)).sum(dim=-1).sum(dim=1)


def bsr_halo_exchange(A: DeviceParBSR, x2: torch.Tensor) -> torch.Tensor:
    """x2: [S, CB, bc] local block vectors -> halo [S, Hb, bc]. The
    all_to_all is the transpose of the [S_src, S_dst, Q, bc] send buffer."""
    S = A.n_shards
    send = _block_take(x2, A.send_idx)                  # [S, S, Q, bc]
    recv = send.transpose(0, 1).reshape(S, -1, A.b_cols)
    return _block_take(recv, A.halo_src)


def bsr_spmv(A: DeviceParBSR, x: torch.Tensor) -> torch.Tensor:
    """b = A x; x [S, CB*bc] scalar layout -> b [S, RB*br]."""
    S, RB, br = A.n_shards, A.brows_pad, A.b_rows
    x2 = x.reshape(S, -1, A.b_cols)
    b = block_product(A.on_blocks, _block_take(x2, A.on_cols))
    if A.off_cols.shape[-1]:
        halo = bsr_halo_exchange(A, x2)
        contrib = block_product(A.off_blocks, _block_take(halo, A.off_cols))
        # the padding of off_rows holds RB: scatter into RB + 1 block rows
        # and drop the last (XLA drops the out-of-bounds rows itself)
        out = torch.zeros((S, RB + 1, br), dtype=b.dtype, device=b.device)
        out.scatter_add_(1, A.off_rows.unsqueeze(-1).expand(-1, -1, br),
                         contrib)
        b = b + out[:, :RB]
    return b.reshape(S, -1)
