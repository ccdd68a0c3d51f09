"""Inter-part neighbor relations with coordinate transforms (port of
hypre_tpu/sstruct/neighbors.py; host numpy / scipy).

Reference: sstruct_mv/sstruct_grid.c — HYPRE_SStructGridSetNeighborPart
registers that a box of one part's index space IS (a transformed view
of) a box of another part's: `coord` permutes axes, `dir` flips them,
and the box corners anchor the affine offset (hypre_SStructNeighbor +
the MapIndex machinery).  hypre uses the relation to route shared-DOF
communication; here inter-part traffic flows through the
U-matrix, so the relation's job is to GENERATE those U couplings: a
stencil entry reaching off part p's box lands — via the transform — on
a concrete cell of the neighbor part.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from ..ops.csr import CSRMatrix
from .grid import SStructGrid


@dataclasses.dataclass(frozen=True)
class NeighborPart:
    """A GridSetNeighborPart record: `box` (ilower, iupper inclusive) in
    part `part`'s index space — typically a ghost layer just outside the
    part — maps onto `nbor_box` of part `nbor_part` via axis map `coord`
    and directions `dir` (hypre index_map / index_dir)."""

    part: int
    ilower: tuple
    iupper: tuple
    nbor_part: int
    nbor_ilower: tuple
    nbor_iupper: tuple
    coord: tuple  # axis d of `part` maps to axis coord[d] of nbor
    dir: tuple    # +1 / -1 per axis of `part`

    def map_index(self, idx) -> tuple:
        """Map an index in `part`'s space (inside the box) to the
        neighbor part's space (sstruct_grid.c hypre_SStructNeighbor
        MapIndex semantics)."""
        idx = tuple(int(i) for i in idx)
        out = [0] * len(idx)
        for d in range(len(idx)):
            t = self.coord[d]
            if self.dir[d] > 0:
                out[t] = self.nbor_ilower[t] + (idx[d] - self.ilower[d])
            else:
                out[t] = self.nbor_iupper[t] - (idx[d] - self.ilower[d])
        return tuple(out)

    def contains(self, idx) -> bool:
        return all(
            self.ilower[d] <= int(idx[d]) <= self.iupper[d]
            for d in range(len(self.ilower))
        )


def build_u_from_neighbors(
    grid: SStructGrid,
    stencils: dict,
    relations,
    var: int = 0,
) -> CSRMatrix:
    """Generate the U-matrix entries for stencil couplings that leave a
    part's box through a registered neighbor relation.

    stencils[part] = dict {offset tuple: value array over the part's
    grid shape} (the same entry dicts StructMatrix.from_dict takes).
    Entries whose target index lies outside the part's box are matched
    against the relations (ghost index in `box`), transformed into the
    neighbor part's index space, and emitted as U couplings in the
    concatenated unknown ordering.  Unmatched out-of-box targets stay
    dropped (Dirichlet truncation), exactly like the intra-part case.
    """
    offsets = grid.offsets()
    rows_l, cols_l, vals_l = [], [], []
    for p in range(grid.nparts):
        shape = grid.grid(p, var).shape
        rel_p = [r for r in relations if r.part == p]
        if not rel_p:
            continue
        base_p = offsets[(p, var)]
        for off, arr in stencils[p].items():
            arr = np.asarray(arr) + np.zeros(shape)
            for I in np.ndindex(*shape):
                J = tuple(I[d] + off[d] for d in range(len(shape)))
                if all(0 <= J[d] < shape[d] for d in range(len(shape))):
                    continue  # intra-part, handled by the S matrix
                for rel in rel_p:
                    if not rel.contains(J):
                        continue
                    Jn = rel.map_index(J)
                    nshape = grid.grid(rel.nbor_part, var).shape
                    if not all(0 <= Jn[d] < nshape[d] for d in range(len(nshape))):
                        continue
                    r = base_p + int(np.ravel_multi_index(I, shape))
                    c = offsets[(rel.nbor_part, var)] + int(
                        np.ravel_multi_index(Jn, nshape)
                    )
                    rows_l.append(r)
                    cols_l.append(c)
                    vals_l.append(float(arr[I]))
                    break
    n = grid.total_size
    U = sp.coo_matrix(
        (np.asarray(vals_l), (np.asarray(rows_l), np.asarray(cols_l))),
        shape=(n, n),
    ).tocsr()
    U.sum_duplicates()
    return CSRMatrix.from_scipy(U)
