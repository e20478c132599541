"""Device smoothers (copy of raptor_tpu.device.relax): hybrid Jacobi, SOR,
SSOR, multicolour SOR/SSOR, l1-Jacobi and Chebyshev, batched over stacked
shards.

Semantics match the reference's hybrid smoothers exactly
(util/linalg/par_relax.cpp): halo values are exchanged once per sweep and
frozen; the on_proc part is Jacobi (jacobi_helper :121-172) or a sequential
Gauss-Seidel sweep (SOR_forward :44-83, SOR_backward :85-119). Note the
reference's forward sweep uses the non-standard update
``x[i] = (x[i] + w*(y[i] - x[i] - rowsum)) / a_ii`` (par_relax.cpp:81) —
reproduced here verbatim; the backward sweep uses the standard weighted form.

The sequential on-shard sweep is the lower-triangular solve
``(D + w L) x_new = c`` with ``c = x + w*(y - x - U x - A_off dist_x)``. At
setup the host computes a **level schedule** of the L-dependency DAG; on the
device the sweep is a Python loop over the levels, each level one parallel
padded gather-multiply-scatter over every shard at once. Padded levels past
a shard's own count are all-masked no-ops. What does not change between
level steps (the rows' 1/a_ii and update masks, flat indices over the
stacked shards) is gathered once when the plan is built, and what a level
needs of c and of the old x once per sweep (``_tri_sweep``).

Rows whose first on_proc entry is not the diagonal are left untouched, as in
the reference (par_relax.cpp:58-64). The functions are named as the JAX
package's ``*_shard`` functions without the suffix: each one runs every
shard of the stacked layout in one call. Each takes a trailing ``T``: a
topology-aware exchange plan (``comm.tap.DeviceTAP``) that its halo
exchanges go through, or None for the plain exchange.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from raptor_tpu_torch import native
from raptor_tpu_torch.core.matrix import CSRMatrix
from raptor_tpu_torch.core.par_matrix import ParCSRMatrix
from raptor_tpu_torch.core.types import ZERO_TOL
from raptor_tpu_torch.device.formats import ell_arrays, ell_spmv, off_spmv
from raptor_tpu_torch.device.par import DeviceParCSR, _gall, halo, on_spmv
from raptor_tpu_torch.profiling.timers import nested_phase


def _split_ldu(a: CSRMatrix) -> Tuple[np.ndarray, CSRMatrix, CSRMatrix]:
    """diag, strict lower L, strict upper U of a local square block."""
    sp_a = a.to_scipy()
    lower = sp.tril(sp_a, k=-1, format="csr")
    upper = sp.triu(sp_a, k=1, format="csr")
    return (sp_a.diagonal(), CSRMatrix.from_scipy(lower),
            CSRMatrix.from_scipy(upper))


def _greedy_coloring(a: CSRMatrix) -> np.ndarray:
    """Greedy graph colouring of the symmetrized on_proc pattern (smallest
    available colour in row order)."""
    m = a.to_scipy()
    sym = (m + m.T).tocsr()
    sym.sort_indices()
    return native.greedy_coloring(sym.indptr, sym.indices)


def _level_schedule(tri: CSRMatrix, reverse: bool) -> List[np.ndarray]:
    """Group rows into dependency levels of a triangular solve.

    Forward (reverse=False): row i depends on cols j < i (lower tri).
    Backward (reverse=True): row i depends on cols j > i (upper tri).
    Rows in the same level have no dependencies among themselves and are
    updated in parallel; the device loops over levels in order.
    """
    n = tri.n_rows
    level = native.level_schedule(tri.indptr, tri.indices, reverse)
    n_levels = int(level.max()) + 1 if n else 1
    counts = np.bincount(level, minlength=n_levels)
    order = np.argsort(level, kind="stable")
    return np.split(order, np.cumsum(counts)[:-1])


def _schedule_arrays(tri: CSRMatrix, levels: List[np.ndarray],
                     NL: int, M: int, W: int):
    rows = np.zeros((NL, M), dtype=np.int32)
    mask = np.zeros((NL, M), dtype=np.float64)
    cols = np.zeros((NL, M, W), dtype=np.int32)
    vals = np.zeros((NL, M, W), dtype=np.float64)
    # row-major ELL view of tri, gathered per level (vectorized)
    ec, ev = ell_arrays(tri, tri.n_rows, W)
    ec, ev = ec.T, ev.T                       # [R, W]
    for l, lv in enumerate(levels):
        m = len(lv)
        rows[l, :m] = lv
        mask[l, :m] = 1.0
        cols[l, :m] = ec[lv]
        vals[l, :m] = ev[lv]
    return rows, mask, cols, vals


@dataclasses.dataclass
class Sweep:
    """A level-scheduled triangular sweep, level-major and flat over the
    stacked shards (a row r of shard s is r + s*R): what one level step
    reads, gathered once from the schedule."""

    rows: torch.Tensor      # [NL, S*M] int64 flat rows (pads: row 0)
    cols: torch.Tensor      # [NL, S*M, W] int64 flat columns
    vals: torch.Tensor      # [NL, S*M, W]
    inv_diag: torch.Tensor  # [NL, S*M] 1 / a_ii of the rows
    ok: torch.Tensor        # [NL, S*M] bool: mask * has_diag[row] > 0


def _sweep(rows, mask, cols, vals, inv_diag, has_diag) -> Sweep:
    """The Sweep of stacked schedule arrays ([S, NL, M], [S, NL, M, W])."""
    S, NL, M, W = cols.shape
    R = inv_diag.shape[1]
    base = torch.arange(S, device=rows.device)[:, None, None] * R
    frows = (rows + base).transpose(0, 1).reshape(NL, S * M)
    fcols = (cols + base[..., None]).transpose(0, 1).reshape(NL, S * M, W)
    fmask = mask.transpose(0, 1).reshape(NL, S * M)
    return Sweep(
        rows=frows, cols=fcols,
        vals=vals.transpose(0, 1).reshape(NL, S * M, W),
        inv_diag=inv_diag.reshape(-1)[frows],
        ok=fmask * has_diag.reshape(-1)[frows] > 0)


@dataclasses.dataclass
class DeviceRelax:
    """Per-shard relaxation plan (stacked over shards like DeviceParCSR);
    the fields of the JAX package's DeviceRelax, then what the port
    derives from them."""

    diag: torch.Tensor       # [S, R] (1.0 on padding / missing diag)
    inv_diag: torch.Tensor   # [S, R]
    has_diag: torch.Tensor   # [S, R] 1.0 where |diag|>zero_tol, row valid
    u_cols: torch.Tensor     # [S, Wu, R] strict upper ELL
    u_vals: torch.Tensor
    l_cols: torch.Tensor     # [S, Wl, R] strict lower ELL
    l_vals: torch.Tensor
    # level schedules: [S, NL, M] rows + mask, [S, NL, M, W] entries
    fwd_rows: torch.Tensor
    fwd_mask: torch.Tensor
    fwd_cols: torch.Tensor
    fwd_vals: torch.Tensor
    bwd_rows: torch.Tensor
    bwd_mask: torch.Tensor
    bwd_cols: torch.Tensor
    bwd_vals: torch.Tensor
    # greedy graph colouring for multicolour GS: [S, NC, R] one-hot
    color_mask: torch.Tensor
    # l1-Jacobi: 1 / (a_ii + sum_{j != i} |a_ij|) over the FULL row
    # (on_proc + off_proc), hypre's l1 norm smoother
    inv_l1_diag: torch.Tensor
    n_fwd_levels: int
    n_bwd_levels: int
    n_colors: int
    # Chebyshev interval for D^{-1} A (power-iteration estimate at setup)
    cheb_lo: float
    cheb_hi: float
    fwd: Sweep               # the schedules, as the sweeps read them
    bwd: Sweep
    color_ok: torch.Tensor   # [NC, S, R] bool: color_mask * has_diag > 0


def _cheb_interval(a: ParCSRMatrix, tr=None):
    """Power-iteration estimate of lambda_max of D^{-1} A, shard by shard
    over a replicated iterate; the interval is [0.3, 1.1] * lambda_max,
    per hypre practice. With a transport (``tr``) the per-shard slices are
    concatenated through it, with the same arithmetic."""
    part = a.partition
    shards = a.shards()
    rng_v = np.random.default_rng(42).random(part.global_num_rows) + 0.1
    v = rng_v / np.linalg.norm(rng_v)
    invd = []
    for blk in shards:
        d = blk.on_proc.diagonal()
        invd.append(np.where(np.abs(d) > ZERO_TOL, d, 1.0))
    lmax = 1.0
    for _ in range(12):
        locs = []
        for i, blk in enumerate(shards):
            s = a.first_shard + i
            c0, c1 = int(part.col_bounds[s]), int(part.col_bounds[s + 1])
            w = blk.on_proc.mult(v[c0:c1])
            if blk.off_proc.nnz:
                w = w + blk.off_proc.mult(v[blk.off_proc_column_map])
            locs.append(w / invd[i])
        w_full = (np.concatenate(locs) if tr is None
                  else tr.allgather_concat(locs))
        nw = np.linalg.norm(w_full)
        if nw <= 0:
            break
        lmax, v = nw, w_full / nw
    return 0.3 * float(lmax), 1.1 * float(lmax)


def build_relax(a: ParCSRMatrix, dA: DeviceParCSR,
                need=("tri", "color"), tr=None) -> DeviceRelax:
    """Host construction of the relaxation plan, in ``dA``'s dtype and on
    its device.

    ``need`` selects the heavy plans: "tri" builds the level-scheduled
    triangular sweeps and L/U ELL blocks (SOR/SSOR/Jacobi row sums),
    "color" the greedy colouring masks (multicolour GS). Chebyshev and
    l1-Jacobi need neither, which saves O(nnz)-scale arrays per level.
    ``tr``: ``a`` may be a local view, of every shard or of one
    controller's, and the pads are agreed through the transport, as
    ``device_put_matrix`` does; the plan holds the view's shards."""
    shards = a.shards()
    S = len(shards)
    R = dA.rows_pad
    need_tri = "tri" in need
    need_color = "color" in need

    empty = CSRMatrix.empty(1, 1)
    per_shard = []
    colorings = []
    for blk in shards:
        if need_tri:
            diag, low, up = _split_ldu(blk.on_proc)
            fl = _level_schedule(low, reverse=False)
            bl = _level_schedule(up, reverse=True)
        else:
            # Chebyshev / l1-Jacobi only read the diagonal
            diag = blk.on_proc.diagonal()
            low, up = empty, empty
            fl, bl = [np.zeros(0, dtype=np.int64)], [np.zeros(0, np.int64)]
        per_shard.append((diag, low, up, fl, bl))
        colorings.append(_greedy_coloring(blk.on_proc) if need_color
                         else np.zeros(1, dtype=np.int64))
    dims = (
        max(1, max(int(c.max()) + 1 if len(c) else 1 for c in colorings)),
        max(len(p[3]) for p in per_shard),
        max(len(p[4]) for p in per_shard),
        max(max((len(lv) for lv in p[3]), default=1) for p in per_shard),
        max(max((len(lv) for lv in p[4]), default=1) for p in per_shard),
        max(1, max((int(np.diff(p[1].indptr).max()) if p[1].nnz else 0)
                   for p in per_shard)),
        max(1, max((int(np.diff(p[2].indptr).max()) if p[2].nnz else 0)
                   for p in per_shard)))
    NC, NLf, NLb, Mf, Mb, Wl, Wu = (max(d) for d in zip(*_gall(tr, dims)))

    diag_a = np.ones((S, R))
    has = np.zeros((S, R))
    u_cols = np.zeros((S, Wu, R), dtype=np.int32)
    u_vals = np.zeros((S, Wu, R))
    l_cols = np.zeros((S, Wl, R), dtype=np.int32)
    l_vals = np.zeros((S, Wl, R))
    f_rows = np.zeros((S, NLf, Mf), dtype=np.int32)
    f_mask = np.zeros((S, NLf, Mf))
    f_cols = np.zeros((S, NLf, Mf, Wl), dtype=np.int32)
    f_vals = np.zeros((S, NLf, Mf, Wl))
    b_rows = np.zeros((S, NLb, Mb), dtype=np.int32)
    b_mask = np.zeros((S, NLb, Mb))
    b_cols = np.zeros((S, NLb, Mb, Wu), dtype=np.int32)
    b_vals = np.zeros((S, NLb, Mb, Wu))
    color_mask = np.zeros((S, NC, R))
    if need_color:
        for s_i, c in enumerate(colorings):
            color_mask[s_i, c, np.arange(len(c))] = 1.0

    for s, (diag, low, up, fl, bl) in enumerate(per_shard):
        n = len(diag)
        diag_a[s, :n] = np.where(np.abs(diag) > ZERO_TOL, diag, 1.0)
        has[s, :n] = (np.abs(diag) > ZERO_TOL).astype(np.float64)
        u_cols[s], u_vals[s] = ell_arrays(up, R, Wu)
        l_cols[s], l_vals[s] = ell_arrays(low, R, Wl)
        f_rows[s], f_mask[s], f_cols[s], f_vals[s] = _schedule_arrays(
            low, fl, NLf, Mf, Wl)
        b_rows[s], b_mask[s], b_cols[s], b_vals[s] = _schedule_arrays(
            up, bl, NLb, Mb, Wu)

    # l1 row norms over the full (on + off) row, hypre l1-Jacobi style
    l1 = np.ones((S, R))
    for s, blk in enumerate(shards):
        n = blk.on_proc.n_rows
        onab = np.bincount(blk.on_proc.row_ids(),
                           weights=np.abs(blk.on_proc.data), minlength=n)
        offab = (np.bincount(blk.off_proc.row_ids(),
                             weights=np.abs(blk.off_proc.data), minlength=n)
                 if blk.off_proc.nnz else np.zeros(n))
        d = diag_a[s, :n]
        row_l1 = d + (onab - np.abs(d)) + offab
        l1[s, :n] = np.where(np.abs(row_l1) > ZERO_TOL, row_l1, 1.0)

    cheb_lo, cheb_hi = _cheb_interval(a, tr)

    def put(x):
        return torch.from_numpy(x).to(dA.device, dA.dtype)

    def put_idx(x):
        return torch.from_numpy(x.astype(np.int64)).to(dA.device)

    # the host-to-card copies: a phase "copy" of the packing's Profiler
    # (``DeviceHierarchy.pack_times``) where one is open
    with nested_phase("copy"):
        inv_diag, has_diag = put(1.0 / diag_a), put(has)
        fwd = (put_idx(f_rows), put(f_mask), put_idx(f_cols), put(f_vals))
        bwd = (put_idx(b_rows), put(b_mask), put_idx(b_cols), put(b_vals))
        color = put(color_mask)
        return DeviceRelax(
            diag=put(diag_a), inv_diag=inv_diag, has_diag=has_diag,
            inv_l1_diag=put(1.0 / l1),
            u_cols=put_idx(u_cols), u_vals=put(u_vals),
            l_cols=put_idx(l_cols), l_vals=put(l_vals),
            fwd_rows=fwd[0], fwd_mask=fwd[1], fwd_cols=fwd[2],
            fwd_vals=fwd[3],
            bwd_rows=bwd[0], bwd_mask=bwd[1], bwd_cols=bwd[2],
            bwd_vals=bwd[3],
            color_mask=color, n_fwd_levels=NLf, n_bwd_levels=NLb,
            n_colors=NC, cheb_lo=cheb_lo, cheb_hi=cheb_hi,
            fwd=_sweep(*fwd, inv_diag, has_diag),
            bwd=_sweep(*bwd, inv_diag, has_diag),
            color_ok=(color * has_diag[:, None, :] > 0).transpose(0, 1)
            .contiguous())


# --- smoothers over stacked shards ----------------------------------------------

def _off(A: DeviceParCSR, dist: torch.Tensor) -> torch.Tensor:
    return off_spmv(A.off_rows, A.off_cols, A.off_vals, dist, A.rows_pad)


def _ad(A: DeviceParCSR, d: torch.Tensor, dist: torch.Tensor):
    """A d with the halo values already exchanged."""
    return on_spmv(A, d) + _off(A, dist)


def jacobi(A: DeviceParCSR, RX: DeviceRelax, x, b, num_sweeps: int,
           omega: float, T=None):
    """Hybrid Jacobi (jacobi_helper, par_relax.cpp:121-172)."""
    for _ in range(num_sweeps):
        dist = halo(A, x, T)
        row_sum = (ell_spmv(RX.l_cols, RX.l_vals, x)
                   + ell_spmv(RX.u_cols, RX.u_vals, x) + _off(A, dist))
        x_new = (1.0 - omega) * x + omega * (b - row_sum) * RX.inv_diag
        x = torch.where(RX.has_diag > 0, x_new, x)
    return x


def _tri_sweep(x, c, omega: float, sw: Sweep, backward_form=False):
    """Level-scheduled triangular sweep.

    forward:  x[i] = (c[i] - w * L x[i]) / a_ii
    backward: x[i] = c[i] + (w * (-U x)[i]) / a_ii  (c holds the w(y-Lx-off)/d
              part already divided; see ssor)

    Each level adds a delta to its rows (add-delta instead of set: padded
    schedule slots all target row 0 with delta 0, so the duplicate writes
    of ``index_add_`` stay deterministic). Every row belongs to one level
    and is written only there, so its old value, and with it everything
    in the delta but the level's L x, is gathered for all levels at once
    when the sweep starts: a level step is one gather of x, a
    multiply-sum and one fused multiply-add into the ``index_add_``. The
    slots that update no row (padding, no diagonal) get a delta of
    exactly 0.
    """
    S, R = x.shape
    xf = x.reshape(-1).clone()
    cr = c.reshape(-1)[sw.rows]              # every level's c[rows]
    if not backward_form:
        cr = cr * sw.inv_diag
    # delta = (c[r] - w lsum) / a_ii - x[r]      (forward)
    #       = c[r] - w lsum / a_ii - x[r]        (backward)
    base = torch.where(sw.ok, cr - xf[sw.rows], 0.0)
    w_inv = torch.where(sw.ok, omega * sw.inv_diag, 0.0)
    for r, cols, vals, b_l, w_l in zip(sw.rows, sw.cols, sw.vals, base,
                                       w_inv):
        lsum = (vals * torch.take(xf, cols)).sum(dim=-1)
        xf.index_add_(0, r, torch.addcmul(b_l, lsum, w_l, value=-1.0))
    return xf.view(S, R)


def sor_forward(A: DeviceParCSR, RX: DeviceRelax, x, y, dist, omega):
    """SOR_forward (par_relax.cpp:44-83): (D + wL) x_new = c, with the
    reference's non-standard c = x + w*(y - x - U x - off dist)."""
    c = x + omega * (y - x - ell_spmv(RX.u_cols, RX.u_vals, x)
                     - _off(A, dist))
    return _tri_sweep(x, c, omega, RX.fwd)


def sor_backward(A: DeviceParCSR, RX: DeviceRelax, x, y, dist, omega):
    """SOR_backward (par_relax.cpp:85-119): standard weighted form
    x[i] = (1-w)x[i] + w(y[i] - Lx - off - U x_new)/a_ii."""
    c = (1.0 - omega) * x + omega * (
        y - ell_spmv(RX.l_cols, RX.l_vals, x) - _off(A, dist)) * RX.inv_diag
    return _tri_sweep(x, c, omega, RX.bwd, backward_form=True)


def sor(A, RX, x, b, num_sweeps: int, omega: float, T=None):
    """sor_helper (par_relax.cpp:174-186)."""
    for _ in range(num_sweeps):
        x = sor_forward(A, RX, x, b, halo(A, x, T), omega)
    return x


def ssor(A, RX, x, b, num_sweeps: int, omega: float, T=None):
    """ssor_helper (par_relax.cpp:189-200): one halo exchange, then
    forward + backward sweeps with the same frozen halo."""
    for _ in range(num_sweeps):
        dist = halo(A, x, T)
        x = sor_forward(A, RX, x, b, dist, omega)
        x = sor_backward(A, RX, x, b, dist, omega)
    return x


def _mc_color_step(A, RX, x, b, off, omega, c):
    """Update rows of colour c with the latest x (standard multicolour GS);
    ``off`` is the frozen halo's A_off product."""
    row_sum = on_spmv(A, x) - RX.diag * x + off
    upd = (1.0 - omega) * x + omega * (b - row_sum) * RX.inv_diag
    return torch.where(RX.color_ok[c], upd, x)


def mc_sor(A, RX, x, b, num_sweeps: int, omega: float, T=None):
    """Multicolour Gauss-Seidel: n_colors fully parallel steps per sweep
    in place of the sequential level schedule."""
    for _ in range(num_sweeps):
        off = _off(A, halo(A, x, T))
        for c in range(RX.n_colors):
            x = _mc_color_step(A, RX, x, b, off, omega, c)
    return x


def mc_ssor(A, RX, x, b, num_sweeps: int, omega: float, T=None):
    for _ in range(num_sweeps):
        off = _off(A, halo(A, x, T))
        for c in range(RX.n_colors):
            x = _mc_color_step(A, RX, x, b, off, omega, c)
        for c in range(RX.n_colors):
            x = _mc_color_step(A, RX, x, b, off, omega,
                               RX.n_colors - 1 - c)
    return x


def l1_jacobi(A, RX, x, b, num_sweeps: int, omega: float, T=None):
    """l1-Jacobi: x += w * (b - A x) / (a_ii + sum_{j!=i} |a_ij|).

    Unconditionally convergent for SPD A (the l1 diagonal dominates the
    row); hypre's default GPU smoother. The reference offers
    Jacobi/SOR/SSOR only (util/linalg/par_relax.cpp)."""
    for _ in range(num_sweeps):
        r = b - _ad(A, x, halo(A, x, T))
        x = torch.where(RX.has_diag > 0, x + omega * r * RX.inv_l1_diag, x)
    return x


def chebyshev(A: DeviceParCSR, RX: DeviceRelax, x: torch.Tensor,
              b: torch.Tensor, num_sweeps: int, omega: float = 1.0,
              T=None) -> torch.Tensor:
    """Chebyshev polynomial smoother of degree ``num_sweeps`` on
    [cheb_lo, cheb_hi] of D^{-1} A: one SpMV per degree. ``omega`` is
    unused (the polynomial fixes the weights)."""
    degree = max(1, num_sweeps)
    theta = 0.5 * (RX.cheb_hi + RX.cheb_lo)
    delta = 0.5 * (RX.cheb_hi - RX.cheb_lo)
    sigma = theta / delta

    r = b - _ad(A, x, halo(A, x, T))
    z = r * RX.inv_diag * RX.has_diag
    d = z / theta
    x = x + d
    rho = 1.0 / sigma
    for _ in range(1, degree):
        r = r - _ad(A, d, halo(A, d, T))
        z = r * RX.inv_diag * RX.has_diag
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


RELAX_FNS = {
    "jacobi": jacobi,
    "sor": sor,
    "ssor": ssor,
    "mc_sor": mc_sor,
    "mc_ssor": mc_ssor,
    "l1_jacobi": l1_jacobi,
    "chebyshev": chebyshev,
}
