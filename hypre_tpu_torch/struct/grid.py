"""Structured grids (the port's own copy of hypre_tpu/struct/grid.py,
pure Python).

Reference: struct_mv/struct_grid.{c,h} (hypre_StructGrid: boxes +
periodicity + ghosts) and the box calculus of box.c.

A grid is a dense nd-array shape: the box calculus the reference needs
to stitch irregular box sets collapses to shape arithmetic on one
logical box per level (multi-box grids are embedded, struct/multibox.py).
Periodicity is carried as flags and handled by the shift operator (wrap
instead of zero-fill).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StructGrid:
    shape: tuple  # (nx,) | (nx, ny) | (nx, ny, nz)
    periodic: tuple = None

    def __post_init__(self):
        if self.periodic is None:
            object.__setattr__(self, "periodic", (0,) * len(self.shape))

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def coarsen(self, cdir: int) -> "StructGrid":
        """Coarse grid = even indices along cdir (cindex 0, stride 2),
        mirroring hypre_StructMapFineToCoarse."""
        shape = list(self.shape)
        shape[cdir] = (shape[cdir] + 1) // 2
        per = list(self.periodic)
        if per[cdir]:
            per[cdir] //= 2
        return StructGrid(tuple(shape), tuple(per))
