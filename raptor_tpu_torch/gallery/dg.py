"""Discontinuous-Galerkin and vector FE problem gallery (copy of
raptor_tpu.gallery.dg, with the DG assembly vectorised).

Completes the reference's MFEM problem set (external/mfem_wrapper.hpp:
15-45, external/mfem/mfem_dg_diffusion.cpp, mfem_dg_elasticity.cpp,
mfem_grad_div.cpp, mfem_adaptive_laplacian.cpp): symmetric interior
penalty (SIPG) DG diffusion and DG elasticity on Q1 quads, an H(div)
grad-div model problem on vector Q1 elements, and a locally refined
("adaptive") Laplacian, assembled directly (2-point Gauss quadrature on
faces, closed-form Q1 volume terms).

On a uniform mesh every element block and every face block of one kind
(interior or boundary, and its side) is the same matrix, so the DG kinds
compute each block once and tile it over the elements and faces with
numpy. The triplets come out in the order the JAX package's loops emit
them (volume terms by element, then the faces normal to x row by row,
then those normal to y column by column; within a face, quadrature point
by point and each block in row-major order, exact zeros left out), so the
duplicate sums, and the matrices, are the same bit for bit.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from raptor_tpu_torch.core.matrix import CSRMatrix

# 2-point Gauss on [0, 1]
_GP = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])
_GW = np.array([0.5, 0.5])


def _q1_shape(xi, eta):
    """Q1 shape values/gradients on the reference square [0,1]^2,
    node order (0,0),(1,0),(0,1),(1,1)."""
    n = np.array([(1 - xi) * (1 - eta), xi * (1 - eta),
                  (1 - xi) * eta, xi * eta])
    dx = np.array([-(1 - eta), (1 - eta), -eta, eta])
    dy = np.array([-(1 - xi), -xi, (1 - xi), xi])
    return n, dx, dy


def _q1_stiffness(hx, hy):
    k = np.zeros((4, 4))
    for xi in _GP:
        for eta in _GP:
            _, dx, dy = _q1_shape(xi, eta)
            gx, gy = dx / hx, dy / hy
            k += 0.25 * hx * hy * (np.outer(gx, gx) + np.outer(gy, gy))
    return k


def _face_quad(side, t):
    """(xi, eta) on face ``side`` of the reference square at parameter
    t; sides: 0=right(x=1), 1=left(x=0), 2=top(y=1), 3=bottom(y=0)."""
    if side == 0:
        return 1.0, t
    if side == 1:
        return 0.0, t
    if side == 2:
        return t, 1.0
    return t, 0.0


# the faces of an nx x ny mesh by kind: (first element's side, second
# element's side or None on the boundary, outward normal of the first
# element, normal direction: 0 for x, 1 for y)
_X_LEFT = (1, None, (-1.0, 0.0), 0)
_X_INNER = (0, 1, (1.0, 0.0), 0)
_X_RIGHT = (0, None, (1.0, 0.0), 0)
_Y_BOTTOM = (3, None, (0.0, -1.0), 1)
_Y_INNER = (2, 3, (0.0, 1.0), 1)
_Y_TOP = (2, None, (0.0, 1.0), 1)


def _entries(blocks):
    """(row, col, value) of each block's nonzeros, block by block, each in
    row-major order: the order ``add`` sees them in the JAX package."""
    rows, cols, vals = [], [], []
    for m in blocks:
        a, b = np.nonzero(m)
        rows.append(a)
        cols.append(b)
        vals.append(m[a, b])
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)


def _tile(dofs, ent):
    """The triplets of one block pattern ``ent`` over faces (or elements)
    whose dofs are the rows of ``dofs``: [faces, entries] each."""
    la, lb, lv = ent
    return dofs[:, la], dofs[:, lb], np.broadcast_to(lv, (len(dofs), len(lv)))


def _dg_assemble(nx, ny, d, ke, face_blocks):
    """Assemble a DG operator with ``d`` dofs an element, element block
    ``ke`` and ``face_blocks(kind)``: the per-quadrature-point blocks of a
    face of that kind, over the dofs of its first element then, inside,
    its second."""
    nel = nx * ny
    el = np.arange(nel, dtype=np.int64).reshape(ny, nx)
    loc = np.arange(d, dtype=np.int64)

    def dofs(*elems):
        return np.concatenate([d * e.reshape(-1, 1) + loc for e in elems],
                              axis=1)

    def faces(groups):
        """The (rows, cols, vals) of the faces of ``groups`` (kind, the
        [lines, faces] elements on each side), interleaved line by line of
        the mesh: a line's first boundary face, its inner faces, its last
        boundary face, then the next line, as the JAX package's loops
        visit them."""
        out = [[], [], []]
        for kind, elems in groups:
            lines = len(elems[0])
            r, c, v = _tile(dofs(*(e.reshape(-1) for e in elems)),
                            _entries(face_blocks(kind)))
            for o, t in zip(out, (r, c, v)):
                o.append(t.reshape(lines, t.size // lines))
        return [np.concatenate(o, axis=1).reshape(-1) for o in out]

    parts = [[t.reshape(-1) for t in _tile(dofs(el.reshape(-1)),
                                           _entries([ke]))]]
    # faces normal to x: for each element row, left, inner, right
    parts.append(faces([(_X_LEFT, (el[:, :1],)),
                        (_X_INNER, (el[:, :-1], el[:, 1:])),
                        (_X_RIGHT, (el[:, -1:],))]))
    # faces normal to y: for each element column, bottom, inner, top
    elt = el.T
    parts.append(faces([(_Y_BOTTOM, (elt[:, :1],)),
                        (_Y_INNER, (elt[:, :-1], elt[:, 1:])),
                        (_Y_TOP, (elt[:, -1:],))]))
    rows, cols, vals = (np.concatenate(t) for t in zip(*parts))
    n_dof = d * nel
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n_dof, n_dof))
    K.sum_duplicates()
    K.sort_indices()
    return CSRMatrix.from_scipy(K)


def dg_diffusion(nx: int, ny: int, sigma: float = 10.0) -> CSRMatrix:
    """SIPG discretization of -Laplace(u) on [0,1]^2, Q1-DG on an
    nx x ny quad mesh with penalty ``sigma`` (mfem_dg_diffusion.cpp
    equivalent; homogeneous Dirichlet enforced weakly on the boundary).

    4 dofs per element; faces add
    -int {du/dn}[v] - int {dv/dn}[u] + (sigma/h) int [u][v]."""
    hx, hy = 1.0 / nx, 1.0 / ny

    def face_blocks(kind):
        side_p, side_m, normal, axis = kind
        h_face, length = (hx, hy) if axis == 0 else (hy, hx)
        elems = [(side_p, 1.0)]
        if side_m is not None:
            elems.append((side_m, -1.0))
        npts = len(_GP)
        vals_n = np.zeros((len(elems) * 4, npts))
        vals_dn = np.zeros((len(elems) * 4, npts))
        for ei, (side, jump_sign) in enumerate(elems):
            for q, t in enumerate(_GP):
                xi, eta = _face_quad(side, t)
                nsh, dx, dy = _q1_shape(xi, eta)
                gd = (dx / hx) * normal[0] + (dy / hy) * normal[1]
                vals_n[ei * 4:ei * 4 + 4, q] = jump_sign * nsh
                vals_dn[ei * 4:ei * 4 + 4, q] = gd
        # averages: interior {w} = (w+ + w-)/2; boundary {w} = w
        avg = 0.5 if side_m is not None else 1.0
        pen = sigma / h_face
        out = []
        for q in range(npts):
            w = _GW[q] * length
            ju = vals_n[:, q]        # jump basis
            an = avg * vals_dn[:, q]  # average normal-derivative basis
            out.append(w * (pen * np.outer(ju, ju) - np.outer(an, ju)
                            - np.outer(ju, an)))
        return out

    return _dg_assemble(nx, ny, 4, _q1_stiffness(hx, hy), face_blocks)


def _elasticity_C(E, nu):
    """Plane-stress constitutive matrix (Voigt: xx, yy, xy)."""
    f = E / (1 - nu * nu)
    return f * np.array([[1.0, nu, 0.0],
                         [nu, 1.0, 0.0],
                         [0.0, 0.0, (1 - nu) / 2.0]])


def dg_elasticity(nx: int, ny: int, E: float = 1.0, nu: float = 0.3,
                  sigma: float = 20.0) -> CSRMatrix:
    """SIPG DG plane-stress elasticity on Q1 quads
    (mfem_dg_elasticity.cpp equivalent): volume term int eps(v):C:eps(u),
    faces -int {t(u)}.[v] - int {t(v)}.[u] + (sigma/h) int [u].[v] with
    traction t(u) = (C eps(u)) n. 8 dofs/element (u,v interleaved)."""
    hx, hy = 1.0 / nx, 1.0 / ny
    C = _elasticity_C(E, nu)

    def B_at(xi, eta):
        """Strain-displacement matrix [3, 8] (Voigt) at (xi, eta)."""
        _, dx, dy = _q1_shape(xi, eta)
        gx, gy = dx / hx, dy / hy
        B = np.zeros((3, 8))
        B[0, 0::2] = gx
        B[1, 1::2] = gy
        B[2, 0::2] = gy
        B[2, 1::2] = gx
        return B

    ke = np.zeros((8, 8))
    for xi in _GP:
        for eta in _GP:
            B = B_at(xi, eta)
            ke += 0.25 * hx * hy * (B.T @ C @ B)

    def face_blocks(kind):
        side_p, side_m, normal, axis = kind
        h_face, length = (hx, hy) if axis == 0 else (hy, hx)
        elems = [(side_p, 1.0)]
        if side_m is not None:
            elems.append((side_m, -1.0))
        nd = len(elems) * 8
        npts = len(_GP)
        # [nd, 2, npts] vector shape values (jump-signed);
        # [nd, 2, npts] traction values
        Nv = np.zeros((nd, 2, npts))
        Tv = np.zeros((nd, 2, npts))
        Nmat = np.array([[normal[0], 0.0, normal[1]],
                         [0.0, normal[1], normal[0]]])   # [2,3] Voigt n.
        for ei, (side, jsign) in enumerate(elems):
            for q, t in enumerate(_GP):
                xi, eta = _face_quad(side, t)
                nsh, _, _ = _q1_shape(xi, eta)
                B = B_at(xi, eta)
                trac = Nmat @ C @ B                      # [2, 8]
                for a in range(4):
                    Nv[ei * 8 + 2 * a, 0, q] = jsign * nsh[a]
                    Nv[ei * 8 + 2 * a + 1, 1, q] = jsign * nsh[a]
                Tv[ei * 8:(ei + 1) * 8, :, q] = trac.T
        avg = 0.5 if side_m is not None else 1.0
        pen = sigma / h_face
        out = []
        for q in range(npts):
            w = _GW[q] * length
            ju = Nv[:, :, q]
            tr = avg * Tv[:, :, q]
            out.append(w * (pen * (ju @ ju.T) - (tr @ ju.T) - (ju @ tr.T)))
        return out

    return _dg_assemble(nx, ny, 8, ke, face_blocks)


def grad_div(nx: int, ny: int, alpha: float = 1.0,
             beta: float = 1.0) -> CSRMatrix:
    """H(div) model problem alpha (div u, div v) + beta (u, v) on
    vector Q1 elements (mfem_grad_div.cpp equivalent), clamped normal
    components on the boundary. 2 dofs/node interleaved."""
    from raptor_tpu_torch.gallery.fem import _q1_grid
    hx, hy = 1.0 / nx, 1.0 / ny
    nodes, conn = _q1_grid(nx, ny)
    ke = np.zeros((8, 8))
    for xi in _GP:
        for eta in _GP:
            nsh, dx, dy = _q1_shape(xi, eta)
            gx, gy = dx / hx, dy / hy
            divv = np.zeros(8)
            divv[0::2] = gx
            divv[1::2] = gy
            mass = np.zeros((8, 8))
            mass[0::2, 0::2] = np.outer(nsh, nsh)
            mass[1::2, 1::2] = np.outer(nsh, nsh)
            ke += 0.25 * hx * hy * (alpha * np.outer(divv, divv)
                                    + beta * mass)
    nel = conn.shape[0]
    edofs = np.empty((nel, 8), dtype=np.int64)
    edofs[:, 0::2] = 2 * conn
    edofs[:, 1::2] = 2 * conn + 1
    rows = np.repeat(edofs, 8, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, 8)).reshape(-1)
    vals = np.tile(ke.reshape(-1), nel)
    n = 2 * (nx + 1) * (ny + 1)
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    # u.n = 0 on the boundary: clamp x-component on x-faces, y on y-faces
    ii = np.arange((nx + 1) * (ny + 1))
    gx = ii % (nx + 1)
    gy = ii // (nx + 1)
    free = np.ones(n, dtype=bool)
    free[2 * ii[(gx == 0) | (gx == nx)]] = False
    free[2 * ii[(gy == 0) | (gy == ny)] + 1] = False
    K = K[free][:, free].tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return CSRMatrix.from_scipy(K)


def adaptive_laplacian(n0: int, n_refine: int = 3,
                       ratio: float = 2.0) -> CSRMatrix:
    """Locally-refined Laplacian (mfem_adaptive_laplacian.cpp analog):
    Q1 FE on a tensor grid whose spacing is geometrically refined by
    ``ratio`` per step toward the (0,0) corner over ``n_refine``
    refinement bands — the operator class AMR produces (strong local
    refinement, h ratios up to ratio^n_refine), on a conforming mesh.
    Dirichlet boundary eliminated."""
    # graded 1-D spacings: n0 coarse cells, each band closer to 0
    # subdivided further
    hs = [1.0] * n0
    for _ in range(n_refine):
        m = max(1, len(hs) // 4)
        refined = []
        for h in hs[:m]:
            refined += [h / ratio] * int(ratio)
        hs = refined + hs[m:]
    hs = np.asarray(hs)
    hs = hs / hs.sum()
    nx = len(hs)
    # tensor mesh, per-element closed-form Q1 Laplacian
    n_nodes = (nx + 1) * (nx + 1)
    rows, cols, vals = [], [], []
    for iy in range(nx):
        for ix in range(nx):
            hx, hy = hs[ix], hs[iy]
            k = _q1_stiffness(hx, hy)
            nid = np.array([iy * (nx + 1) + ix, iy * (nx + 1) + ix + 1,
                            (iy + 1) * (nx + 1) + ix,
                            (iy + 1) * (nx + 1) + ix + 1])
            for a in range(4):
                for b in range(4):
                    rows.append(nid[a])
                    cols.append(nid[b])
                    vals.append(k[a, b])
    K = sp.csr_matrix((vals, (rows, cols)), shape=(n_nodes, n_nodes))
    ii = np.arange(n_nodes)
    gx = ii % (nx + 1)
    gy = ii // (nx + 1)
    free = (gx > 0) & (gx < nx) & (gy > 0) & (gy < nx)
    K = K[free][:, free].tocsr()
    K.sum_duplicates()
    K.sort_indices()
    return CSRMatrix.from_scipy(K)
