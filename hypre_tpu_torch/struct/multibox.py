"""Multi-box structured grids: per-box data + ghost-exchange plans (port
of hypre_tpu/struct/multibox.py).

Reference: struct_mv/struct_grid.{c,h} (grids are box SETS),
communication_info.c (hypre_CreateCommInfoFromStencil: per-box ghost
regions = grown box minus itself, intersected with neighbor boxes ->
send/recv box lists) and struct_communication.c (strided pack
descriptors): grids assembled from arbitrary box unions, including
ranks that own nothing (the reference's emptyproc regression family).

Each box's data is a dense tensor on the device, padded by the stencil
radius for the apply; ghost fills are static slice-copy plans (the
CommEntryType analog: (src box, src slice, dst slice) tuples computed
from box intersections at setup).  The struct solvers run on the
canonical bounding-box tensor assembled through the same box maps
(`to_struct_matrix` embeds a non-rectangular union exactly), so the
solve is decomposition-invariant by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .box import bounding_box, subtract_box_list, union_size


@dataclasses.dataclass(frozen=True)
class GhostCopy:
    src: int  # source box index
    src_slc: tuple  # slice into source INTERIOR array
    dst_slc: tuple  # slice into destination PADDED array


class MultiBoxGrid:
    """A structured grid that is a union of boxes (possibly from a
    -P/-b decomposition with empty ranks)."""

    def __init__(self, boxes, periodic=None):
        self.boxes = [b for b in boxes]
        self.nonempty = [i for i, b in enumerate(self.boxes) if not b.empty]
        self.bbox = bounding_box(self.boxes)
        self.ndim = self.bbox.ndim
        self.periodic = periodic or (0,) * self.ndim

    def is_rectangular(self) -> bool:
        """Union covers the bounding box exactly (no holes/overlaps)."""
        return union_size([b for b in self.boxes if not b.empty]) \
            == self.bbox.size

    # ------------------------------------------------------------------
    def ghost_plans(self, radius: int):
        """Per-box ghost-fill plans for a stencil of `radius`
        (hypre_CreateCommInfoFromStencil role): for box i, the grown
        region minus the box itself, intersected with every other box.
        Regions covered by no box read zero (physical boundary)."""
        plans: list[list[GhostCopy]] = []
        for i in self.nonempty:
            bi = self.boxes[i]
            gi = bi.grow(radius)
            ghost_regions = subtract_box_list([gi], bi)
            copies = []
            for j in self.nonempty:
                if j == i:
                    continue
                bj = self.boxes[j]
                for reg in ghost_regions:
                    sec = reg.intersect(bj)
                    if sec.empty:
                        continue
                    copies.append(GhostCopy(
                        src=j,
                        src_slc=sec.slice_in(bj),
                        dst_slc=sec.slice_in(gi),
                    ))
            plans.append(copies)
        return plans


class MultiBoxVector:
    """Per-box dense arrays over a MultiBoxGrid."""

    def __init__(self, grid: MultiBoxGrid, arrays: dict):
        self.grid = grid
        self.arrays = dict(arrays)  # box index -> tensor (box shape)

    @classmethod
    def from_global(cls, grid: MultiBoxGrid, x, *, device="cuda"):
        """Scatter a canonical bounding-box array (numpy or a tensor)
        into the boxes, on `device`."""
        x = torch.as_tensor(x).to(device)
        arrs = {}
        for i in grid.nonempty:
            b = grid.boxes[i]
            arrs[i] = x[b.slice_in(grid.bbox)].clone()
        return cls(grid, arrs)

    def to_global(self) -> torch.Tensor:
        """Assemble the canonical bounding-box tensor (zeros off-union),
        float64 like the JAX package's, on the boxes' device."""
        some = next(iter(self.arrays.values()))
        out = torch.zeros(self.grid.bbox.shape, dtype=torch.float64,
                          device=some.device)
        for i in self.grid.nonempty:
            b = self.grid.boxes[i]
            out[b.slice_in(self.grid.bbox)] = self.arrays[i]
        return out


def multibox_matvec(grid: MultiBoxGrid, entries: dict, x: MultiBoxVector,
                    plans=None, radius=None):
    """y = A x on a multi-box grid.

    entries: {offset -> {box index -> coefficient array}} (per-box
    variable coefficients, the struct_matrix data layout).
    The ghost exchange runs the GhostCopy plans (box-boundary values
    from neighbor boxes); uncovered ghost reads are zero.  Coefficients
    may be numpy arrays or tensors; they go to x's device.
    """
    offsets = list(entries.keys())
    if radius is None:
        radius = max(
            (max(abs(o) for o in off) if off else 0) for off in offsets
        )
    if plans is None:
        plans = grid.ghost_plans(radius)
    out = {}
    for pi, i in enumerate(grid.nonempty):
        b = grid.boxes[i]
        gshape = tuple(s + 2 * radius for s in b.shape)
        xi = x.arrays[i]
        xg = torch.zeros(gshape, dtype=xi.dtype, device=xi.device)
        core = tuple(slice(radius, radius + s) for s in b.shape)
        xg[core] = xi
        for cp in plans[pi]:
            xg[cp.dst_slc] = x.arrays[cp.src][cp.src_slc]
        acc = None
        for off in offsets:
            coef = entries[off].get(i)
            if coef is None:
                continue
            slc = tuple(
                slice(radius + o, radius + o + s)
                for o, s in zip(off, b.shape)
            )
            t = torch.as_tensor(coef).to(xi.device) * xg[slc]
            acc = t if acc is None else acc + t
        out[i] = (acc if acc is not None else
                  torch.zeros(b.shape, dtype=xi.dtype, device=xi.device))
    return MultiBoxVector(grid, out)


def union_mask(grid: MultiBoxGrid) -> np.ndarray:
    """Boolean bounding-box array: True on cells covered by the union."""
    m = np.zeros(grid.bbox.shape, dtype=bool)
    for i in grid.nonempty:
        m[grid.boxes[i].slice_in(grid.bbox)] = True
    return m


def to_struct_matrix(grid: MultiBoxGrid, entries: dict, dtype=np.float64):
    """EXACT masked bounding-box embedding of a (possibly
    NON-RECTANGULAR) box-union operator.

    Returns (entries_bbox, inside) where entries_bbox are canonical
    stencil coefficient arrays on the bounding box with (a) couplings
    whose source or target falls outside the union zeroed and (b) unit
    diagonals on exterior cells.  The embedded operator is therefore
    block-diagonal — (union system) ⊕ (identity on the exterior) — so
    ANY struct solver run on the bounding box with exterior b = 0
    solves the union system EXACTLY; smoothing or coarse-grid work on
    the exterior block cannot couple back: the reference's solvers run
    on arbitrary box unions (struct_mv grids are box SETS —
    struct_grid.c), the solvers here on one dense lattice, so the union
    is embedded, not scattered.  Dropped inside->outside
    couplings match multibox_matvec's ghost semantics (uncovered ghost
    reads are zero), so the embedded matvec equals the multi-box
    matvec on the union bit-for-bit.  Host numpy, as in the JAX package.
    """
    inside = union_mask(grid)
    shape = grid.bbox.shape
    out = {}
    for o, per_box in entries.items():
        arr = np.zeros(shape, dtype=dtype)
        for i, a in per_box.items():
            arr[grid.boxes[i].slice_in(grid.bbox)] = np.asarray(a)
        if any(o):
            # keep i -> i+o only when both endpoints are in the union
            tgt = np.zeros(shape, dtype=bool)
            dst = tuple(slice(max(0, -oo), s - max(0, oo))
                        for oo, s in zip(o, shape))
            src = tuple(slice(max(0, oo), s + min(0, oo))
                        for oo, s in zip(o, shape))
            tgt[dst] = inside[src]
            arr = np.where(inside & tgt, arr, 0.0)
        else:
            arr = np.where(inside, arr, 1.0)
        out[o] = arr
    return out, inside
