"""Reference sstruct grid-spec (.in) file reader (the port's own copy of
hypre_tpu/sstruct/infile.py, pure Python).

Reference: test/sstruct.c:194 (SScanProblemIndex — `(i± j± k± : sx sy
sz)` ProblemIndex form: 9 ints [index, plus-signs, shifts], pre-shifted
on read), :1127 (MapProblemIndex — refinement maps
m*i + (m-1)*sign + shift), and the keyword parser (:600-900).

Covered keywords: GridCreate, GridSetExtents, GridSetVariables,
GridSetPeriodic, GridSetNeighborPart, StencilCreate, StencilSetEntry,
GraphSetStencil, GraphAddEntries, MatrixSetValues, MatrixAddToValues,
FacParts.  ProcessPool/FEM/RhsAdd keywords are accepted and ignored
(distribution is np=1-equivalent by the .saved contract).
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class ProblemIndex:
    """9-int hypre ProblemIndex: idx (pre-shifted), plus-signs, shifts."""

    idx: list
    sign: list
    shift: list

    def mapped(self, m):
        """MapProblemIndex (sstruct.c:1127): un-shift, scale, re-shift."""
        idx = [
            m[d] * (self.idx[d] - self.shift[d]) + (m[d] - 1) * self.sign[d]
            + self.shift[d]
            for d in range(3)
        ]
        return ProblemIndex(idx, list(self.sign), list(self.shift))

    def point(self):
        return tuple(self.idx)


def _scan_index(tok: str, ndim: int) -> ProblemIndex:
    """Parse `i± j± k±[: sx sy sz]` (the () are stripped by the caller)."""
    idx = [0, 0, 0]
    sign = [0, 0, 0]
    shift = [0, 0, 0]
    parts = tok.split(":")
    m = re.findall(r"(-?\d+)([+-])", parts[0])
    assert len(m) == ndim, tok
    for d, (v, s) in enumerate(m):
        idx[d] = int(v)
        sign[d] = 1 if s == "+" else 0
    if len(parts) > 1:
        sh = [int(x) for x in parts[1].split()]
        for d in range(ndim):
            shift[d] = sh[d]
            idx[d] += sh[d]
    return ProblemIndex(idx, sign, shift)


@dataclasses.dataclass
class GraphEntryBoxes:
    part: int
    ilower: ProblemIndex
    iupper: ProblemIndex
    stride: list
    var: int
    to_part: int
    to_ilower: ProblemIndex
    to_iupper: ProblemIndex
    to_stride: list
    to_var: int
    index_map: list
    index_sign: list
    entry: int
    value: float


@dataclasses.dataclass
class MatSetBox:
    part: int
    ilower: ProblemIndex
    iupper: ProblemIndex
    stride: list
    var: int
    entry: int
    value: float


@dataclasses.dataclass
class ProblemData:
    ndim: int = 3
    nparts: int = 0
    extents: dict = dataclasses.field(default_factory=dict)  # part -> (ilo, iup)
    vartypes: dict = dataclasses.field(default_factory=dict)  # part -> [types]
    periodic: dict = dataclasses.field(default_factory=dict)
    neighbors: list = dataclasses.field(default_factory=list)
    stencils: dict = dataclasses.field(default_factory=dict)  # sid -> [(off, var, val)]
    part_stencil: dict = dataclasses.field(default_factory=dict)  # (part, var) -> sid
    graph_entries: list = dataclasses.field(default_factory=list)
    matset: list = dataclasses.field(default_factory=list)
    matadd: list = dataclasses.field(default_factory=list)
    fac_parts: dict = dataclasses.field(default_factory=dict)
    # part -> (plevel, rfactor[3]) — sstruct_fac.c:619-624 "FacParts:"


def _tokens_after(line: str, key: str) -> str:
    return line.split(key, 1)[1].strip()


def _split_indices(s: str, n: int):
    """Extract the first n (...) groups and the remaining scalar tokens."""
    groups = re.findall(r"\(([^)]*)\)", s)
    rest = re.sub(r"\([^)]*\)", " ", s)
    return groups[:n], rest


def _ints_in_brackets(s: str):
    return [
        [int(x) for x in grp.split()]
        for grp in re.findall(r"\[([^\]]*)\]", s)
    ]


def read_infile(path: str) -> ProblemData:
    data = ProblemData()
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("GridCreate:"):
                nd, nparts = [int(x) for x in _tokens_after(line, "GridCreate:").split()[:2]]
                data.ndim = nd
                data.nparts = nparts
            elif line.startswith("GridSetExtents:"):
                rest = _tokens_after(line, "GridSetExtents:")
                part = int(rest.split()[0])
                groups, _ = _split_indices(rest, 2)
                ilo = _scan_index(groups[0], data.ndim)
                iup = _scan_index(groups[1], data.ndim)
                data.extents[part] = (ilo, iup)
            elif line.startswith("GridSetVariables:"):
                toks = _tokens_after(line, "GridSetVariables:")
                part = int(toks.split()[0])
                types = _ints_in_brackets(toks)[0]
                data.vartypes[part] = types
            elif line.startswith("GridSetPeriodic:"):
                toks = _tokens_after(line, "GridSetPeriodic:")
                part = int(toks.split()[0])
                data.periodic[part] = _ints_in_brackets(toks)[0]
            elif line.startswith("GridSetNeighborPart:"):
                rest = _tokens_after(line, "GridSetNeighborPart:")
                groups, _ = _split_indices(rest, 4)
                scalars = [int(x) for x in re.findall(
                    r"-?\d+", re.sub(r"\([^)]*\)|\[[^\]]*\]", " ", rest))]
                brackets = _ints_in_brackets(rest)
                data.neighbors.append(dict(
                    part=scalars[0],
                    ilower=_scan_index(groups[0], data.ndim),
                    iupper=_scan_index(groups[1], data.ndim),
                    nbor_part=scalars[1],
                    nbor_ilower=_scan_index(groups[2], data.ndim),
                    nbor_iupper=_scan_index(groups[3], data.ndim),
                    index_map=brackets[0] if brackets else list(range(data.ndim)),
                    index_dir=brackets[1] if len(brackets) > 1 else [1] * data.ndim,
                ))
            elif line.startswith("StencilCreate:"):
                pass  # sizes are implied by the SetEntry lines
            elif line.startswith("StencilSetEntry:"):
                toks = _tokens_after(line, "StencilSetEntry:")
                scalars = toks.split()
                sid = int(scalars[0])
                entry = int(scalars[1])
                off = _ints_in_brackets(toks)[0]
                tail = toks.rsplit("]", 1)[1].split()
                var = int(tail[0])
                val = float(tail[1])
                ent_list = data.stencils.setdefault(sid, [])
                assert entry == len(ent_list), "out-of-order stencil entry"
                ent_list.append((tuple(off), var, val))
            elif line.startswith("GraphSetStencil:"):
                part, var, sid = [
                    int(x) for x in _tokens_after(line, "GraphSetStencil:").split()[:3]
                ]
                data.part_stencil[(part, var)] = sid
            elif line.startswith("GraphAddEntries:"):
                rest = _tokens_after(line, "GraphAddEntries:")
                groups, _ = _split_indices(rest, 4)
                brackets = _ints_in_brackets(rest)
                nobox = re.sub(r"\([^)]*\)|\[[^\]]*\]", " ", rest)
                scalars = [float(x) for x in nobox.split()]
                # layout: part [ilow iup] stride var to_part [to_ilow
                # to_iup] to_stride to_var index_map entry value
                part = int(scalars[0])
                var = int(scalars[1])
                to_part = int(scalars[2])
                to_var = int(scalars[3])
                entry = int(scalars[4])
                value = float(scalars[5])
                to_iup = _scan_index(groups[3], data.ndim)
                to_ilo = _scan_index(groups[2], data.ndim)
                sgn = [
                    -1 if to_iup.idx[d] < to_ilo.idx[d] else 1
                    for d in range(3)
                ]
                imap = brackets[2] if len(brackets) > 2 else list(range(data.ndim))
                data.graph_entries.append(GraphEntryBoxes(
                    part=part,
                    ilower=_scan_index(groups[0], data.ndim),
                    iupper=_scan_index(groups[1], data.ndim),
                    stride=brackets[0] + [1] * (3 - len(brackets[0])),
                    var=var,
                    to_part=to_part,
                    to_ilower=to_ilo,
                    to_iupper=to_iup,
                    to_stride=brackets[1] + [1] * (3 - len(brackets[1])),
                    to_var=to_var,
                    index_map=imap + list(range(len(imap), 3)),
                    index_sign=sgn,
                    entry=entry,
                    value=value,
                ))
            elif line.startswith("MatrixSetValues:") or line.startswith(
                    "MatrixAddToValues:"):
                key = line.split(":", 1)[0] + ":"
                rest = _tokens_after(line, key)
                groups, _ = _split_indices(rest, 2)
                brackets = _ints_in_brackets(rest)
                nobox = re.sub(r"\([^)]*\)|\[[^\]]*\]", " ", rest)
                scalars = nobox.split()
                box = MatSetBox(
                    part=int(scalars[0]),
                    ilower=_scan_index(groups[0], data.ndim),
                    iupper=_scan_index(groups[1], data.ndim),
                    stride=(brackets[0] + [1, 1, 1])[:3] if brackets else [1, 1, 1],
                    var=int(scalars[1]),
                    entry=int(scalars[2]),
                    value=float(scalars[-1]),
                )
                (data.matset if key == "MatrixSetValues:" else data.matadd
                 ).append(box)
            elif line.startswith("FacParts:"):
                toks = _tokens_after(line, "FacParts:")
                part, plevel = [int(x) for x in toks.split()[:2]]
                rfac = _ints_in_brackets(toks)[0]
                data.fac_parts[part] = (
                    plevel, rfac + [1] * (3 - len(rfac))
                )
            # ProcessPool*/FEM*/RhsAdd are accepted silently
    return data


def map_refinement(data: ProblemData, r) -> None:
    """Apply `-r rx ry rz` (sstruct.c: MapProblemIndex on every index)."""
    m = list(r) + [1] * (3 - len(r))
    for part, (ilo, iup) in list(data.extents.items()):
        data.extents[part] = (ilo.mapped(m), iup.mapped(m))
    for g in data.graph_entries:
        g.ilower = g.ilower.mapped(m)
        g.iupper = g.iupper.mapped(m)
        # to-side maps with m PERMUTED by index_map (sstruct.c:1266-1275);
        # strides are NOT scaled
        mmap = [m[g.index_map[0]], m[g.index_map[1]], m[g.index_map[2]]]
        g.to_ilower = g.to_ilower.mapped(mmap)
        g.to_iupper = g.to_iupper.mapped(mmap)
    for b in data.matset + data.matadd:
        b.ilower = b.ilower.mapped(m)
        b.iupper = b.iupper.mapped(m)
    for nb in data.neighbors:
        nb["ilower"] = nb["ilower"].mapped(m)
        nb["iupper"] = nb["iupper"].mapped(m)
        # neighbor-side corners map with m permuted by index_map
        # (sstruct.c:1727-1734)
        imap = nb["index_map"]
        mmap = [m[imap[0]], m[imap[1]] if len(imap) > 1 else 1,
                m[imap[2]] if len(imap) > 2 else 1]
        nb["nbor_ilower"] = nb["nbor_ilower"].mapped(mmap)
        nb["nbor_iupper"] = nb["nbor_iupper"].mapped(mmap)
