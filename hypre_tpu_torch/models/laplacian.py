"""The problem generators (port of hypre_tpu/models/laplacian.py): the
7-point, 5-point, 9-point and 27-point Laplacians, the 7-point
convection-diffusion operator, the systems Laplacian, the rotated
anisotropic Laplacian and the variable-coefficient convection-diffusion
operator, and the 7-point Laplacian's row blocks for the distributed
path (`laplacian_7pt_row_block`).

Reference analog: parcsr_ls/par_laplace.c (GenerateLaplacian,
GenerateSysLaplacian), par_laplace_9pt.c, par_laplace_27pt.c,
par_difconv.c, par_rotate_7pt.c and par_vardifconv.c with the stencil
values of test/ij.c:7799-7814 (7-pt), :8885-8898 (9-pt), :9011-9016
(27-pt) and :8205-8343 (difconv).  Grid indexing is hypre's: ix
fastest, global row = ix + nx*(iy + ny*iz).  Homogeneous Dirichlet:
out-of-grid neighbors are dropped and the diagonal is not adjusted.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..ops.csr import CSRMatrix


def _stencil_matrix(nx, ny, nz, offsets, values) -> CSRMatrix:
    """Sum of shifted diagonals for offsets (dx,dy,dz) -> value, built
    as CSR directly from a per-row [n, k] entry table pre-sorted by
    column offset.  Repeated flat offsets (1-wide axes) take the COO
    dedup path."""
    n = nx * ny * nz
    live = [(o, v) for o, v in zip(offsets, values) if v != 0.0]
    col_off = [dx + nx * (dy + ny * dz) for (dx, dy, dz), _ in live]
    if len(set(col_off)) != len(col_off):
        return _stencil_matrix_coo(nx, ny, nz, live)
    return CSRMatrix(*_stencil_rows(nx, ny, nz, live, 0, n), (n, n))


def _stencil_rows(nx, ny, nz, live, lo, hi):
    """(indptr, cols, vals) of rows [lo, hi) of the sum of the shifted
    diagonals `live` [((dx, dy, dz), value)]: global columns, each row's
    entries in column-offset order, out-of-grid neighbours dropped."""
    order = np.argsort([dx + nx * (dy + ny * dz) for (dx, dy, dz), _ in live])
    idx = np.arange(lo, hi, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    k = len(live)
    nr = hi - lo
    cols = np.empty((nr, k), dtype=np.int64)
    vals = np.empty((nr, k))
    valid = np.empty((nr, k), dtype=bool)
    for slot, oi in enumerate(order):
        (dx, dy, dz), v = live[oi]
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        valid[:, slot] = ok
        cols[:, slot] = jx + nx * (jy + ny * jz)
        vals[:, slot] = v
    flat = valid.ravel()
    indptr = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return indptr, cols.ravel()[flat], vals.ravel()[flat]


def _stencil_7pt(nx, ny, nz, cx, cy, cz):
    """(offsets, values) of the 7-point Laplacian (ij.c:7799-7814)."""
    diag = 0.0
    if nx > 1:
        diag += 2.0 * cx
    if ny > 1:
        diag += 2.0 * cy
    if nz > 1:
        diag += 2.0 * cz
    return ([(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
             (0, 0, -1), (0, 0, 1)],
            [diag, -cx, -cx, -cy, -cy, -cz, -cz])


def laplacian_7pt_row_block(nx, ny, nz, lo, hi, cx=1.0, cy=1.0, cz=1.0):
    """Rows [lo, hi) of the 3D 7-pt Laplacian as a scipy CSR block with
    GLOBAL columns: the distributed-generation path (par_laplace.c
    GenerateLaplacian builds only a rank's rows; no rank holds the
    global matrix).  Feed the per-shard blocks to
    parallel.ParCSR.from_row_blocks."""
    offsets, values = _stencil_7pt(nx, ny, nz, cx, cy, cz)
    live = [(o, v) for o, v in zip(offsets, values) if v != 0.0]
    indptr, cols, vals = _stencil_rows(nx, ny, nz, live, lo, hi)
    return sp.csr_matrix((vals, cols, indptr), shape=(hi - lo, nx * ny * nz))


def _stencil_matrix_coo(nx, ny, nz, live) -> CSRMatrix:
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows_list, cols_list, vals_list = [], [], []
    for (dx, dy, dz), v in live:
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        rows_list.append(idx[ok])
        cols_list.append(jx[ok] + nx * (jy[ok] + ny * jz[ok]))
        vals_list.append(np.full(int(ok.sum()), v))
    M = sp.coo_matrix(
        (np.concatenate(vals_list),
         (np.concatenate(rows_list), np.concatenate(cols_list))),
        shape=(n, n),
    ).tocsr()
    M.sum_duplicates()
    M.sort_indices()
    return CSRMatrix.from_scipy(M)


def laplacian_7pt(nx, ny=1, nz=1, cx=1.0, cy=1.0, cz=1.0) -> CSRMatrix:
    """3D 7-point Laplacian (ij.c:7799-7814 values + GenerateLaplacian)."""
    return _stencil_matrix(nx, ny, nz, *_stencil_7pt(nx, ny, nz, cx, cy, cz))


def laplacian_27pt(nx, ny, nz) -> CSRMatrix:
    """3D 27-point Laplacian (ij.c:9011-9016: diag 26, neighbors -1)."""
    ndim_gt1 = (nx > 1) + (ny > 1) + (nz > 1)
    diag = {3: 26.0, 2: 8.0}.get(ndim_gt1, 2.0)
    offsets = [(0, 0, 0)] + [
        (dx, dy, dz)
        for dx in (-1, 0, 1)
        for dy in (-1, 0, 1)
        for dz in (-1, 0, 1)
        if (dx, dy, dz) != (0, 0, 0)
    ]
    values = [diag] + [-1.0] * 26
    return _stencil_matrix(nx, ny, nz, offsets, values)


def difconv_7pt(
    nx,
    ny=1,
    nz=1,
    cx=1.0,
    cy=1.0,
    cz=1.0,
    ax=1.0,
    ay=1.0,
    az=1.0,
    atype=0,
) -> CSRMatrix:
    """7-pt convection-diffusion (ij.c BuildParDifConv :8205-8343).

    atype 0: forward scheme (a/h on the plus-side neighbor)
    atype 1: backward scheme
    atype 2: upwind per sign of a (here: backward, matching a>0)
    atype 3: centered differences
    h = 1/(nx+1) etc., as test/ij.c sets hinx.
    """
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    cx2, cy2, cz2 = cx / hx**2, cy / hy**2, cz / hz**2
    diag = 0.0
    if atype == 0:
        w, s, d = -cx2, -cy2, -cz2
        e, n_, u = -cx2 + ax / hx, -cy2 + ay / hy, -cz2 + az / hz
        if nx > 1:
            diag += 2.0 * cx2 - ax / hx
        if ny > 1:
            diag += 2.0 * cy2 - ay / hy
        if nz > 1:
            diag += 2.0 * cz2 - az / hz
    elif atype in (1, 2):
        w, s, d = -cx2 - ax / hx, -cy2 - ay / hy, -cz2 - az / hz
        e, n_, u = -cx2, -cy2, -cz2
        if nx > 1:
            diag += 2.0 * cx2 + ax / hx
        if ny > 1:
            diag += 2.0 * cy2 + ay / hy
        if nz > 1:
            diag += 2.0 * cz2 + az / hz
    else:  # centered
        w, s, d = -cx2 - ax / (2 * hx), -cy2 - ay / (2 * hy), -cz2 - az / (2 * hz)
        e, n_, u = -cx2 + ax / (2 * hx), -cy2 + ay / (2 * hy), -cz2 + az / (2 * hz)
        if nx > 1:
            diag += 2.0 * cx2
        if ny > 1:
            diag += 2.0 * cy2
        if nz > 1:
            diag += 2.0 * cz2
    offsets = [
        (0, 0, 0),
        (-1, 0, 0),
        (1, 0, 0),
        (0, -1, 0),
        (0, 1, 0),
        (0, 0, -1),
        (0, 0, 1),
    ]
    values = [diag, w, e, s, n_, d, u]
    return _stencil_matrix(nx, ny, nz, offsets, values)


def laplacian_5pt_2d(nx, ny, c=1.0) -> CSRMatrix:
    """2D 5-point Laplacian (the ex5 problem, unscaled: diag 4, offd -1)."""
    return laplacian_7pt(nx, ny, 1, cx=c, cy=c, cz=0.0)


def laplacian_9pt(nx, ny) -> CSRMatrix:
    """2D 9-point Laplacian (ij.c:8885-8898: diag 8, all 8 neighbors -1)."""
    diag = 0.0
    if nx > 1:
        diag += 2.0
    if ny > 1:
        diag += 2.0
    if nx > 1 and ny > 1:
        diag += 4.0
    offsets = [(0, 0, 0)] + [
        (dx, dy, 0) for dx in (-1, 0, 1) for dy in (-1, 0, 1) if (dx, dy) != (0, 0)
    ]
    values = [diag] + [-1.0] * 8
    return _stencil_matrix(nx, ny, 1, offsets, values)


# test/ij.c BuildParSysLaplacian's default inter-function coupling
# matrices (sys_opt 0)
_SYS_MTRX = {
    2: [[2.0, 1.0], [1.0, 2.0]],
    3: [[2.0, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 2.0]],
    4: [
        [1.01, 1.0, 0.0, 0.0],
        [1.0, 2.0, 1.0, 0.0],
        [0.0, 1.0, 1.01, 0.0],
        [2.0, 1.0, 0.0, 1.0],
    ],
}

# test/ij.c's -sysL_opt coupling variants (ij.c:7826-7975)
_SYS_OPT_MTRX = {
    (2, 1): [[1.0, 0.0], [0.0, 1.0]],
    (2, 2): [[1.0, 0.0], [0.0, 20.0]],
    (2, 3): [[1.0, 2.0], [2.0, 1.0]],
    (2, 4): [[1.0, 1.0], [1.0, 1.0]],
    (2, 5): [[1.0, 1.1], [1.1, 1.0]],
    (2, 6): [[1.1, 1.0], [1.0, 1.1]],
    (3, 1): [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
    (3, 2): [[1.0, 0.0, 0.0], [0.0, 20.0, 0.0], [0.0, 0.0, 0.01]],
    (3, 3): [[1.01, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 1.01]],
    (3, 4): [[3.0, 1.0, 0.0], [1.0, 4.0, 2.0], [0.0, 2.0, 0.25]],
    (3, 5): [[2.0, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 2.0]],
}


def sys_laplacian_7pt(nx: int, ny: int, nz: int, num_fun: int, mtrx=None,
                      cx: float = 1.0, cy: float = 1.0, cz: float = 1.0,
                      sys_opt: int = 0) -> CSRMatrix:
    """Systems 7-pt Laplacian: A = L (x) M with interleaved unknowns
    (row = grid_index * num_fun + function), as
    parcsr_ls/par_laplace.c GenerateSysLaplacian with the test/ij.c
    -sysL / -sysL_opt coupling matrices."""
    L = laplacian_7pt(nx, ny, nz, cx, cy, cz).to_scipy()
    if mtrx is None and sys_opt:
        mtrx = _SYS_OPT_MTRX.get((num_fun, sys_opt))
    M = np.asarray(
        mtrx if mtrx is not None else _SYS_MTRX.get(num_fun, np.eye(num_fun)),
        dtype=np.float64,
    )
    A = sp.kron(L, M, format="csr")
    A.sort_indices()
    return CSRMatrix.from_scipy(A)


def rotate_7pt(nx: int, ny: int, alpha_deg: float, eps: float) -> CSRMatrix:
    """2D rotated anisotropic Laplacian (parcsr_ls/par_rotate_7pt.c):
    -div(K grad u) with K from rotation angle alpha and anisotropy eps,
    on a 7-point 2D stencil (the mixed derivative on the skew pair)."""
    alpha = np.deg2rad(alpha_deg)
    c, s = np.cos(alpha), np.sin(alpha)
    cxx = c * c + eps * s * s
    cyy = s * s + eps * c * c
    cxy = 2.0 * (1.0 - eps) * c * s

    n = nx * ny
    idx = np.arange(n)
    ix, iy = idx % nx, idx // nx
    rows_l, cols_l, vals_l = [], [], []

    def add(dx, dy, v):
        ok = (ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
        rows_l.append(idx[ok])
        cols_l.append(idx[ok] + dx + nx * dy)
        vals_l.append(np.full(int(ok.sum()), v))

    add(0, 0, 2 * cxx + 2 * cyy - 1.0 * cxy)
    add(1, 0, -cxx + 0.5 * cxy)
    add(-1, 0, -cxx + 0.5 * cxy)
    add(0, 1, -cyy + 0.5 * cxy)
    add(0, -1, -cyy + 0.5 * cxy)
    add(1, 1, -0.5 * cxy)
    add(-1, -1, -0.5 * cxy)
    M = sp.csr_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, n),
    )
    M.sum_duplicates()
    M.sort_indices()
    return CSRMatrix.from_scipy(M)


def vardifconv_7pt(nx: int, ny: int, nz: int, eps: float = 1.0) -> CSRMatrix:
    """Variable-coefficient diffusion-convection
    (parcsr_ls/par_vardifconv.c): -div(a(x) grad u) + b(x).grad u with
    a(x) = eps (1 + sin-bump), first-order upwind convection."""
    n = nx * ny * nz
    idx = np.arange(n)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    x, y = (ix + 1) * hx, (iy + 1) * hy
    a = eps * (1.0 + 0.5 * np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y))
    bx, by = y - 0.5, 0.5 - x

    rows_l, cols_l, vals_l = [], [], []

    def add(dx, dy, dz, v):
        ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0) & (iy + dy < ny)
              & (iz + dz >= 0) & (iz + dz < nz))
        rows_l.append(idx[ok])
        cols_l.append(idx[ok] + dx + nx * (dy + ny * dz))
        vals_l.append(np.asarray(v)[ok] if np.ndim(v) else np.full(int(ok.sum()), v))

    dfx, dfy, dfz = a / hx**2, a / hy**2, a / hz**2
    ux, uy = np.abs(bx) / hx, np.abs(by) / hy
    add(0, 0, 0, 2 * dfx + 2 * dfy + 2 * dfz + ux + uy)
    add(1, 0, 0, -dfx + np.where(bx < 0, bx / hx, 0.0))
    add(-1, 0, 0, -dfx - np.where(bx > 0, bx / hx, 0.0))
    add(0, 1, 0, -dfy + np.where(by < 0, by / hy, 0.0))
    add(0, -1, 0, -dfy - np.where(by > 0, by / hy, 0.0))
    add(0, 0, 1, -dfz)
    add(0, 0, -1, -dfz)
    M = sp.csr_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, n),
    )
    M.sum_duplicates()
    M.sort_indices()
    return CSRMatrix.from_scipy(M)
