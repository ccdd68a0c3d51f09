"""The benchmark's own build of the `ij` stencil matrices.

hypre's `src/test/ij.c` generates its Laplacians point by point on an
nx x ny x nz grid, the x index fastest (row = ix + nx * (iy + ny * iz)),
homogeneous Dirichlet: a neighbour outside the grid is dropped and the
diagonal stays as it is.

* `7pt` (`-laplacian`): diagonal 2 (cx + cy + cz), -c on the six face
  neighbours (ij.c, BuildParLaplacian, all c = 1 here);
* `27pt` (`-27pt`): diagonal 26, -1 on the 26 neighbours of the
  3 x 3 x 3 box (ij.c, BuildParLaplacian27pt).

Plain numpy and scipy; nothing here comes from the program.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

STENCILS = ("7pt", "27pt")


def stencil_entries(stencil: str):
    """[((dx, dy, dz), value)] of the stencil, the centre first."""
    if stencil == "7pt":
        faces = [(-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1),
                 (0, 0, 1)]
        return [((0, 0, 0), 6.0)] + [(f, -1.0) for f in faces]
    if stencil == "27pt":
        box = [d for d in itertools.product((-1, 0, 1), repeat=3)
               if d != (0, 0, 0)]
        return [((0, 0, 0), 26.0)] + [(d, -1.0) for d in box]
    raise ValueError(f"unknown stencil {stencil!r}; known: {STENCILS}")


def stencil_matrix(stencil: str, nx: int, ny: int, nz: int) -> sp.csr_matrix:
    """The stencil's matrix on the grid, float64 CSR, sorted columns."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    rows, cols, vals = [], [], []
    for (dx, dy, dz), v in stencil_entries(stencil):
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny) & (jz >= 0)
              & (jz < nz))
        rows.append(idx[ok])
        cols.append(jx[ok] + nx * (jy[ok] + ny * jz[ok]))
        vals.append(np.full(int(ok.sum()), v))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    A.sort_indices()
    return A


def laplacian_7pt(cfg: dict) -> sp.csr_matrix:
    """`-laplacian -n nx ny nz` on the configuration's grid."""
    return stencil_matrix("7pt", *cfg["grid"])


def laplacian_27pt(cfg: dict) -> sp.csr_matrix:
    """`-27pt -n nx ny nz` on the configuration's grid."""
    return stencil_matrix("27pt", *cfg["grid"])
