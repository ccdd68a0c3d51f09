"""The 3D 7-point Laplacian (port of hypre_tpu/models/laplacian.py).

Reference analog: parcsr_ls/par_laplace.c (GenerateLaplacian) with the
stencil values of test/ij.c:7799-7814.  Grid indexing is hypre's: ix
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
