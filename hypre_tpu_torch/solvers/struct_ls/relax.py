"""Struct smoothers: point Jacobi and red-black Gauss-Seidel (port of
hypre_tpu/solvers/struct_ls/relax.py).

Reference: struct_ls/point_relax.c (weighted pointwise relaxation with
ComputePkg overlap), struct_ls/red_black_gs.c (red/black ordered GS —
parity coloring of (i+j+k), red sweep then black sweep).

Each half-sweep is one stencil matvec and a masked update: the coloring
makes GS order-independent within a color, so no wavefront schedule is
needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ...struct.matrix import StructMatrix, struct_matvec
from ..krylov.common import tmap, tsub


def parity_mask(shape, parity: int, *, device="cuda", origin=None
                ) -> torch.Tensor:
    """True where the index sum has `parity` (0: red).  `origin`: the
    global index of the block's first point (a shard's block of a
    sharded grid colours by its global index)."""
    origin = origin or (0,) * len(shape)
    idx = sum(np.meshgrid(*[np.arange(o, o + s) for o, s in zip(origin, shape)],
                          indexing="ij"))
    return torch.from_numpy((idx % 2) == parity).to(device)


def point_jacobi(A: StructMatrix, dinv, u, f, weight=1.0):
    """One weighted Jacobi sweep; on a grid tensor or a sharded vector
    (A sharded, dinv its blocks)."""
    r = tsub(f, struct_matvec(A, u))
    return tmap(lambda uu, d, rr: uu + weight * d * rr, u, dinv, r)


def red_black_gs(A: StructMatrix, dinv, u, f, red_mask, pre: bool = True):
    """One RB (pre) or BR (post) sweep (red_black_gs.c ordering); on a
    grid tensor or a sharded vector (red_mask its blocks)."""
    for black in ((False, True) if pre else (True, False)):
        r = tsub(f, struct_matvec(A, u))
        u = tmap(lambda m, uu, d, rr: torch.where(~m if black else m,
                                                  uu + d * rr, uu),
                 red_mask, u, dinv, r)
    return u


def pointset_mask(shape, stride, index, *, device="cuda", origin=None
                  ) -> torch.Tensor:
    """Boolean mask of the axis-strided pointset {x : x_d % stride_d ==
    index_d} — the hypre_PointRelaxSetPointset geometry
    (point_relax.c:1592 generic engine; pointsets are strided
    sublattices per dimension).  `origin` as for `parity_mask`."""
    origin = origin or (0,) * len(shape)
    grids = np.meshgrid(*[np.arange(o, o + s) for o, s in zip(origin, shape)],
                        indexing="ij")
    m = np.ones(shape, dtype=bool)
    for g, st, ix in zip(grids, stride, index):
        m &= (g % int(st)) == int(ix)
    return torch.from_numpy(m).to(device)


def point_relax(A: StructMatrix, dinv, u, f, pointsets, weight=1.0):
    """Generic weighted pointwise relaxation over an ordered list of
    pointset masks (point_relax.c hypre_PointRelax): each pointset
    updates from a FRESH residual, so the sweep is a multicolor
    Gauss-Seidel whose colors are the pointsets; one full-lattice
    pointset degenerates to weighted Jacobi, the 2-color parity pair is
    red-black GS.  `pointsets`: boolean masks (see pointset_mask) or
    (stride, index) tuples resolved against u's shape and device."""
    for ps in pointsets:
        mask = (ps if isinstance(ps, torch.Tensor)
                else pointset_mask(u.shape, *ps, device=u.device))
        r = f - struct_matvec(A, u)
        u = torch.where(mask, u + weight * dinv * r, u)
    return u
