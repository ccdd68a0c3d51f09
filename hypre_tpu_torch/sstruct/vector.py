"""SStruct vectors: nested tuples of per-(part, var) grid tensors (port of
hypre_tpu/sstruct/vector.py).

Reference: sstruct_mv/sstruct_vector.c.  The Krylov helpers take tuples
of parts (solvers/krylov/common.py), so an SStructVector is simply a
nested tuple indexed [part][var].
"""

from __future__ import annotations

import torch

from .grid import SStructGrid

# an SStructVector is tuple[tuple[Tensor, ...], ...] indexed [part][var]
SStructVector = tuple


def zeros(grid: SStructGrid, dtype=torch.float64, *,
          device="cuda") -> SStructVector:
    return tuple(
        tuple(torch.zeros(g.shape, dtype=dtype, device=device) for g in pv)
        for pv in grid.parts
    )


def full(grid: SStructGrid, value, dtype=torch.float64, *,
         device="cuda") -> SStructVector:
    return tuple(
        tuple(torch.full(g.shape, value, dtype=dtype, device=device)
              for g in pv)
        for pv in grid.parts
    )


def pack_vector(x: SStructVector) -> torch.Tensor:
    """Concatenate to the global unknown ordering (for the U-matrix)."""
    return torch.cat([xv.reshape(-1) for pv in x for xv in pv])


def unpack_vector(flat: torch.Tensor, grid: SStructGrid) -> SStructVector:
    """Views of `flat` as the parts, in the global unknown ordering."""
    out = []
    acc = 0
    for pv in grid.parts:
        row = []
        for g in pv:
            row.append(flat[acc : acc + g.size].reshape(g.shape))
            acc += g.size
        out.append(tuple(row))
    return tuple(out)
