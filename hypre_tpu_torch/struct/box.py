"""Box calculus + BoxManager for multi-box structured grids (the port's
own copy of hypre_tpu/struct/box.py, pure Python).

Reference: struct_mv/box.h:44-84 (hypre_Index / hypre_Box / BoxArray),
box_algebra.c (intersect / subtract / union), box_manager.c:427,1128
(distributed directory of box -> owner entries, assemble + region
query), and the test driver's -P/-b decomposition (test/struct.c:
global extent = n*P per dim, b boxes per processor, extra ranks own
nothing — the emptyproc regression family).

Boxes are host-side metadata (int tuples) used at setup to build
ghost-exchange plans and canonical-array assembly maps; device data
lives in per-box dense tensors (struct/multibox.py) or in the stitched
canonical tensor the struct solvers consume.  The reference's
distributed directory (BoxManager + struct assumed partition) collapses
to an in-process table, replicated on every process.
"""

from __future__ import annotations

import dataclasses
import itertools


@dataclasses.dataclass(frozen=True)
class Box:
    """Closed index box [imin, imax] (hypre convention, inclusive).
    Empty when any imax[d] < imin[d]."""

    imin: tuple
    imax: tuple

    def __post_init__(self):
        assert len(self.imin) == len(self.imax)

    @property
    def ndim(self) -> int:
        return len(self.imin)

    @property
    def shape(self) -> tuple:
        return tuple(
            max(0, hi - lo + 1) for lo, hi in zip(self.imin, self.imax)
        )

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def empty(self) -> bool:
        return self.size == 0

    def intersect(self, other: "Box") -> "Box":
        """hypre_IntersectBoxes."""
        return Box(
            tuple(max(a, b) for a, b in zip(self.imin, other.imin)),
            tuple(min(a, b) for a, b in zip(self.imax, other.imax)),
        )

    def contains(self, other: "Box") -> bool:
        return other.empty or (
            all(a <= b for a, b in zip(self.imin, other.imin))
            and all(a >= b for a, b in zip(self.imax, other.imax))
        )

    def grow(self, radius) -> "Box":
        """hypre_BoxGrowByValue/Array: expand by radius per dim (int or
        per-dim sequence)."""
        if isinstance(radius, int):
            radius = (radius,) * self.ndim
        return Box(
            tuple(lo - r for lo, r in zip(self.imin, radius)),
            tuple(hi + r for hi, r in zip(self.imax, radius)),
        )

    def shift(self, offset) -> "Box":
        return Box(
            tuple(lo + o for lo, o in zip(self.imin, offset)),
            tuple(hi + o for hi, o in zip(self.imax, offset)),
        )

    def slice_in(self, other: "Box"):
        """numpy slice tuple of SELF's region inside OTHER's local array
        (caller guarantees other.contains(self))."""
        return tuple(
            slice(lo - olo, hi - olo + 1)
            for lo, hi, olo in zip(self.imin, self.imax, other.imin)
        )


def subtract_boxes(a: Box, b: Box) -> list:
    """a \\ b as a disjoint box list (hypre_SubtractBoxes: peel slabs
    dimension by dimension; at most 2*ndim boxes)."""
    ib = a.intersect(b)
    if ib.empty:
        return [] if a.empty else [a]
    out = []
    rem = a
    for d in range(a.ndim):
        lo, hi = rem.imin[d], rem.imax[d]
        blo, bhi = ib.imin[d], ib.imax[d]
        if blo > lo:  # slab below
            imin, imax = list(rem.imin), list(rem.imax)
            imax[d] = blo - 1
            out.append(Box(tuple(imin), tuple(imax)))
        if bhi < hi:  # slab above
            imin, imax = list(rem.imin), list(rem.imax)
            imin[d] = bhi + 1
            out.append(Box(tuple(imin), tuple(imax)))
        imin, imax = list(rem.imin), list(rem.imax)
        imin[d], imax[d] = blo, bhi
        rem = Box(tuple(imin), tuple(imax))
    return [x for x in out if not x.empty]


def subtract_box_list(boxes: list, b: Box) -> list:
    out = []
    for a in boxes:
        out.extend(subtract_boxes(a, b))
    return out


def union_size(boxes: list) -> int:
    """Total cells covered (boxes may overlap): inclusion by peeling —
    size(union) = sum over i of size(box_i \\ union(box_<i>))."""
    total = 0
    for i, b in enumerate(boxes):
        rem = [b]
        for prev in boxes[:i]:
            rem = subtract_box_list(rem, prev)
        total += sum(x.size for x in rem)
    return total


def bounding_box(boxes: list) -> Box:
    boxes = [b for b in boxes if not b.empty]
    if not boxes:
        return Box((0,), (-1,))
    nd = boxes[0].ndim
    return Box(
        tuple(min(b.imin[d] for b in boxes) for d in range(nd)),
        tuple(max(b.imax[d] for b in boxes) for d in range(nd)),
    )


class BoxArray:
    """Ordered list of (possibly empty) boxes (hypre_BoxArray)."""

    def __init__(self, boxes=()):
        self.boxes = list(boxes)

    def __len__(self):
        return len(self.boxes)

    def __iter__(self):
        return iter(self.boxes)

    def __getitem__(self, i):
        return self.boxes[i]

    def append(self, b: Box):
        self.boxes.append(b)

    @property
    def size(self) -> int:
        return sum(b.size for b in self.boxes)


@dataclasses.dataclass
class BoxManEntry:
    box: Box
    owner: int  # process id
    info: object = None  # payload (hypre stores box-id + extra)


class BoxManager:
    """Directory of box -> owner entries with region queries
    (box_manager.c hypre_BoxManCreate:427 / Assemble:1128 /
    hypre_BoxManIntersect).  Single-table form (see module docstring)."""

    def __init__(self, ndim: int):
        self.ndim = ndim
        self.entries: list[BoxManEntry] = []
        self._assembled = False

    def add_entry(self, box: Box, owner: int, info=None):
        assert not self._assembled, "BoxManager already assembled"
        self.entries.append(BoxManEntry(box, owner, info))

    def assemble(self):
        """Sort entries (owner, insertion) — hypre's global exchange
        collapses to a local sort when the table is replicated."""
        self.entries.sort(key=lambda e: e.owner)
        self._assembled = True

    def intersect(self, region: Box) -> list:
        """Entries whose box meets `region` (hypre_BoxManIntersect)."""
        return [
            e for e in self.entries
            if not e.box.intersect(region).empty
        ]

    def gather_all(self) -> list:
        return list(self.entries)


def distribute_PB(n_local, P, B, nproc: int):
    """The struct driver's decomposition (test/struct.c): global extent
    = n_local * B * P per dim; each of the first prod(P) ranks owns
    prod(B) boxes of shape n_local; ranks beyond prod(P) own NOTHING
    (the emptyproc family).  Returns [(rank, Box)] plus the global box.
    """
    nd = len(n_local)
    ptot = 1
    for p in P:
        ptot *= p
    owners = []
    for rank, pidx in enumerate(itertools.product(
            *[range(p) for p in reversed(P)])):
        pidx = tuple(reversed(pidx))
        for bidx in itertools.product(*[range(b) for b in reversed(B)]):
            bidx = tuple(reversed(bidx))
            imin = tuple(
                (pidx[d] * B[d] + bidx[d]) * n_local[d]
                for d in range(nd)
            )
            imax = tuple(imin[d] + n_local[d] - 1 for d in range(nd))
            owners.append((rank, Box(imin, imax)))
    glob = Box(
        (0,) * nd,
        tuple(n_local[d] * B[d] * P[d] - 1 for d in range(nd)),
    )
    # ranks in [prod(P), nproc) exist but own nothing — callers see them
    # via the rank ids only; the box list simply has no entries for them
    assert nproc >= ptot or nproc == 0
    return owners, glob
