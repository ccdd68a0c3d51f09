"""The 3D 7-point and 27-point Laplacians and the 7-point
convection-diffusion operator (port of hypre_tpu/models/laplacian.py:
laplacian_7pt, laplacian_27pt, difconv_7pt).

Reference analog: parcsr_ls/par_laplace.c (GenerateLaplacian),
par_laplace_27pt.c and par_difconv.c with the stencil values of
test/ij.c:7799-7814 (7-pt), :9011-9016 (27-pt) and :8205-8343
(difconv).  Grid indexing is hypre's: ix fastest, global row = ix +
nx*(iy + ny*iz).  Homogeneous Dirichlet: out-of-grid neighbors are
dropped and the diagonal is not adjusted.
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
    order = np.argsort(col_off)
    k = len(live)
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    cols = np.empty((n, k), dtype=np.int64)
    vals = np.empty((n, k))
    valid = np.empty((n, k), dtype=bool)
    for slot, oi in enumerate(order):
        (dx, dy, dz), v = live[oi]
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = (jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0) & (jz < nz)
        valid[:, slot] = ok
        cols[:, slot] = jx + nx * (jy + ny * jz)
        vals[:, slot] = v
    flat = valid.ravel()
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(axis=1), out=indptr[1:])
    return CSRMatrix(indptr, cols.ravel()[flat], vals.ravel()[flat], (n, n))


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
    diag = 0.0
    if nx > 1:
        diag += 2.0 * cx
    if ny > 1:
        diag += 2.0 * cy
    if nz > 1:
        diag += 2.0 * cz
    offsets = [
        (0, 0, 0),
        (-1, 0, 0),
        (1, 0, 0),
        (0, -1, 0),
        (0, 1, 0),
        (0, 0, -1),
        (0, 0, 1),
    ]
    values = [diag, -cx, -cx, -cy, -cy, -cz, -cz]
    return _stencil_matrix(nx, ny, nz, offsets, values)


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
