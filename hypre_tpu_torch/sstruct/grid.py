"""Semi-structured grids: parts x variables (port of
hypre_tpu/sstruct/grid.py, pure Python).

Reference: sstruct_mv/sstruct_grid.{c,h} (sstruct_grid.h:29-49 — nparts
StructGrids with per-part variable types CELL/NODE/XFACE/...; inter-part
neighbor relations).

A part is a dense StructGrid per variable; inter-part couplings are
carried by the unstructured U-matrix (sstruct/matrix.py) rather than
coordinate-transformed pencil exchanges — the U-matrix IS the general
mechanism in the reference too (Ulink entries), all inter-part traffic
is routed through it.
"""

from __future__ import annotations

import dataclasses
import enum

from ..struct.grid import StructGrid


class VarType(enum.Enum):
    CELL = 0
    NODE = 1
    XFACE = 2
    YFACE = 3
    ZFACE = 4
    XEDGE = 5
    YEDGE = 6
    ZEDGE = 7


@dataclasses.dataclass(frozen=True)
class SStructGrid:
    """parts[p] = tuple of per-variable StructGrids for part p."""

    parts: tuple  # tuple[tuple[StructGrid, ...], ...]
    var_types: tuple = None  # parallel structure of VarType

    def __post_init__(self):
        if self.var_types is None:
            vt = tuple(tuple(VarType.CELL for _ in pv) for pv in self.parts)
            object.__setattr__(self, "var_types", vt)

    @property
    def nparts(self) -> int:
        return len(self.parts)

    def nvars(self, part: int) -> int:
        return len(self.parts[part])

    def grid(self, part: int, var: int = 0) -> StructGrid:
        return self.parts[part][var]

    def sizes(self):
        return [[g.size for g in pv] for pv in self.parts]

    @property
    def total_size(self) -> int:
        return sum(g.size for pv in self.parts for g in pv)

    def offsets(self):
        """Global unknown offsets per (part, var) in concatenation order."""
        out = {}
        acc = 0
        for p, pv in enumerate(self.parts):
            for v, g in enumerate(pv):
                out[(p, v)] = acc
                acc += g.size
        return out
