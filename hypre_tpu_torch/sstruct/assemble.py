"""Assemble an SStruct system from a parsed grid-spec file (port of
hypre_tpu/sstruct/assemble.py).

Reference: test/sstruct.c's build path — GridSetExtents +
GetVariableBox (:237, vartype-dependent variable boxes),
GraphAddEntries enumeration (:2950: strided boxes, to-index via
index_map/sign/strides), graph-entry value setting (:3073),
MatrixSetValues/AddToValues boxes, b = ones, x0 = 0.

The result is the port's SStructMatrix (S stencils per part/var pair +
one U CSR for all non-stencil couplings), built on the host with the JAX
package's arithmetic (the same S blocks and U, bit for bit); the S blocks
and the frozen U then live on `device`.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

from ..ops.csr import CSRMatrix
from ..struct.grid import StructGrid
from ..struct.matrix import StructMatrix
from .grid import SStructGrid, VarType
from .infile import ProblemData
from .matrix import SStructMatrix

_VAR_ILO_ADJ = {
    0: (0, 0, 0),   # CELL
    1: (-1, -1, -1),  # NODE
    2: (-1, 0, 0),  # XFACE
    3: (0, -1, 0),  # YFACE
    4: (0, 0, -1),  # ZFACE
    5: (0, -1, -1),  # XEDGE
    6: (-1, 0, -1),  # YEDGE
    7: (-1, -1, 0),  # ZEDGE
}


def _var_box(cell_ilo, cell_iup, vartype, ndim):
    adj = _VAR_ILO_ADJ[vartype]
    ilo = tuple(cell_ilo[d] + adj[d] for d in range(ndim))
    iup = tuple(cell_iup[d] for d in range(ndim))
    return ilo, iup


class AssembledSystem:
    def __init__(self, data: ProblemData, dtype=np.float64, *,
                 device="cuda"):
        self.data = data
        self.device = device
        nd = data.ndim
        self.var_boxes = {}  # (part, var) -> (ilo, shape)
        parts = []
        vartypes = []
        for p in range(data.nparts):
            ilo_pi, iup_pi = data.extents[p]
            cell_ilo = ilo_pi.point()[:nd]
            cell_iup = iup_pi.point()[:nd]
            types = data.vartypes[p]
            vartypes.append(tuple(VarType(t) for t in types))
            per = tuple(data.periodic.get(p, [0] * nd)[:nd])
            grids = []
            for v, t in enumerate(types):
                vlo, vup = _var_box(cell_ilo, cell_iup, t, nd)
                shape = tuple(vup[d] - vlo[d] + 1 for d in range(nd))
                self.var_boxes[(p, v)] = (vlo, shape)
                grids.append(StructGrid(shape, per))
            parts.append(tuple(grids))
        self.grid = SStructGrid(
            parts=tuple(parts), var_types=tuple(vartypes)
        )
        self.dtype = dtype
        self._offsets = self.grid.offsets()
        self._build_matrix()

    # ------------------------------------------------------------------
    def _lid(self, part, var, index):
        """Flat local id of `index` (global coords) in its variable box,
        or None if outside."""
        vlo, shape = self.var_boxes[(part, var)]
        nd = self.data.ndim
        loc = tuple(index[d] - vlo[d] for d in range(nd))
        if any(x < 0 or x >= shape[d] for d, x in enumerate(loc)):
            return None
        return int(np.ravel_multi_index(loc, shape))

    def gid(self, part, var, index):
        lid = self._lid(part, var, index)
        if lid is None:
            return None
        return self._offsets[(part, var)] + lid

    # ------------------------------------------------------------------
    def _build_matrix(self):
        data = self.data
        nd = data.ndim
        smats = {}
        sdata_ref = {}
        xmats = set()  # (part, vi, vj) with different-shape var boxes
        for (p, v), sid in data.part_stencil.items():
            vlo, shape = self.var_boxes[(p, v)]
            ent = {}
            for off, to_var, val in data.stencils[sid]:
                offt = tuple(off[:nd])
                key = (p, v, to_var)
                ent.setdefault(key, {})[offt] = np.full(shape, val,
                                                       dtype=self.dtype)
            for (pp, vi, vj), entries in ent.items():
                sdata_ref[(pp, vi, vj)] = entries
                if self.var_boxes[(pp, vi)][1] != self.var_boxes[(pp, vj)][1]:
                    # cross-variable coupling between DIFFERENT-shape
                    # variable boxes (e.g. cell<->node in TEST_sstruct
                    # mixed-vartype configs): no stencil-translation S
                    # form exists — these legs assemble into the U CSR
                    # below, exactly hypre's Ulink role for couplings
                    # the struct layer can't carry
                    # (sstruct_mv/sstruct_matrix.c UMatrix path)
                    xmats.add((pp, vi, vj))
                    continue
                smats[(pp, vi, vj)] = entries

        # MatrixSet/AddToValues boxes (stencil-entry overrides)
        for box, is_set in itertools.chain(
                ((b, True) for b in data.matset),
                ((b, False) for b in data.matadd)):
            p, v = box.part, box.var
            sid = data.part_stencil[(p, v)]
            ents = data.stencils[sid]
            if box.entry >= len(ents):
                continue  # graph-entry overrides live in the U build
            off, to_var, _ = ents[box.entry]
            key = (p, v, to_var)
            entries = sdata_ref[key]
            arr = np.asarray(entries[tuple(off[:nd])])
            vlo, shape = self.var_boxes[(p, v)]
            lo = box.ilower.point()[:nd]
            up = box.iupper.point()[:nd]
            slc = tuple(
                slice(lo[d] - vlo[d], up[d] - vlo[d] + 1, box.stride[d])
                for d in range(nd)
            )
            if is_set:
                arr[slc] = box.value
            else:
                arr[slc] += box.value
            entries[tuple(off[:nd])] = arr
            if key not in xmats:
                smats[key] = entries

        # U part: GraphAddEntries (sstruct.c:2950 enumeration + :3073
        # value setting — Set semantics per entry, duplicates summed at
        # matvec exactly as distinct hypre entries are)
        rows, cols, vals = [], [], []

        # cross-variable different-shape stencil legs -> U couplings:
        # row at global index idx of var vi couples to var vj at
        # idx + off (hypre evaluates cross-variable offsets in the
        # to-variable's index space anchored at the row's cell); legs
        # whose target falls outside vj's box are dropped, the same
        # boundary truncation the S path applies.
        for (pp, vi, vj) in xmats:
            vlo_i, shape_i = self.var_boxes[(pp, vi)]
            vlo_j, shape_j = self.var_boxes[(pp, vj)]
            off_i = self.grid.offsets()[(pp, vi)]
            off_j = self.grid.offsets()[(pp, vj)]
            loc = np.stack(
                np.meshgrid(*[np.arange(s) for s in shape_i],
                            indexing="ij"),
                axis=-1,
            ).reshape(-1, nd)
            rid = off_i + np.arange(loc.shape[0])
            for offt, arr in sdata_ref[(pp, vi, vj)].items():
                tgt = loc + np.asarray(vlo_i) + np.asarray(offt) \
                    - np.asarray(vlo_j)
                ok = np.all((tgt >= 0) & (tgt < np.asarray(shape_j)),
                            axis=1)
                if not ok.any():
                    continue
                cid = off_j + np.ravel_multi_index(
                    tuple(tgt[ok].T), shape_j
                )
                rows.extend(rid[ok].tolist())
                cols.extend(cid.tolist())
                vals.extend(np.asarray(arr).reshape(-1)[ok].tolist())

        # GridSetNeighborPart routing: stencil legs leaving a part's box
        # that land in a registered neighbor window become couplings to
        # the neighbor part's cells (HYPRE_SStructGridSetNeighborPart:
        # image[map[d]] = nbor_ilower[map[d]] + dir[d]*(idx[d]-ilower[d]))
        if data.neighbors:
            for (p, v), sid in data.part_stencil.items():
                vlo, shape = self.var_boxes[(p, v)]
                for off, to_var, val in data.stencils[sid]:
                    offt = tuple(off[:nd]) + (0,) * (3 - nd)
                    for loc in itertools.product(
                            *[range(s) for s in shape]):
                        idx = [vlo[d] + loc[d] for d in range(nd)] + [0] * (3 - nd)
                        tgt = [idx[d] + offt[d] for d in range(3)]
                        if self._lid(p, to_var, tgt) is not None:
                            continue  # in-box: the S part owns it
                        for rec in data.neighbors:
                            if rec["part"] != p:
                                continue
                            rl = rec["ilower"].point()
                            ru = rec["iupper"].point()
                            if not all(
                                min(rl[d], ru[d]) <= tgt[d] <= max(rl[d], ru[d])
                                for d in range(nd)
                            ):
                                continue
                            img = [0, 0, 0]
                            nlo = rec["nbor_ilower"].point()
                            for d in range(nd):
                                t = rec["index_map"][d]
                                img[t] = nlo[t] + rec["index_dir"][d] * (
                                    tgt[d] - rl[d]
                                )
                            r = self.gid(p, v, idx)
                            c = self.gid(rec["nbor_part"], to_var, img)
                            if r is not None and c is not None:
                                rows.append(r)
                                cols.append(c)
                                vals.append(val)
                            break
        n = self.grid.total_size
        offs = self.grid.offsets()
        for g in data.graph_entries:
            lo = g.ilower.point()
            up = g.iupper.point()
            ranges = [
                range(lo[d], up[d] + 1, g.stride[d]) for d in range(3)
            ]
            for idx2 in ranges[2] if nd > 2 else [0]:
                for idx1 in ranges[1] if nd > 1 else [0]:
                    for idx0 in ranges[0]:
                        index = [idx0, idx1, idx2]
                        to_index = [0, 0, 0]
                        for d in range(3):
                            j = g.index_map[d]
                            k = (index[d] - lo[d]) // g.stride[d]
                            k *= g.index_sign[d]
                            to_index[j] = (
                                g.to_ilower.idx[j] + k * g.to_stride[d]
                            )
                        r = self.gid(g.part, g.var, index)
                        c = self.gid(g.to_part, g.to_var, to_index)
                        assert r is not None and c is not None, (
                            "graph entry outside variable boxes: "
                            f"{index} -> {to_index}"
                        )
                        rows.append(r)
                        cols.append(c)
                        vals.append(g.value)
        U = None
        if rows:
            Uc = sp.coo_matrix(
                (np.asarray(vals, dtype=self.dtype),
                 (np.asarray(rows), np.asarray(cols))),
                shape=(n, n),
            ).tocsr()
            Uc.sum_duplicates()
            U = CSRMatrix.from_scipy(Uc)
        # each S block once, from its final entry arrays (the JAX
        # package rebuilds a block after every override box; the last
        # build is the same arrays)
        smats = {k: StructMatrix.from_dict(
            e, StructGrid(self.var_boxes[(k[0], k[1])][1]),
            device=self.device) for k, e in smats.items()}
        self.A = SStructMatrix(self.grid, smats, U, device=self.device)

    # ------------------------------------------------------------------
    def ones_rhs(self):
        return np.ones(self.grid.total_size, dtype=self.dtype)
