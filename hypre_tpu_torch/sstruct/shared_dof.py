"""Shared-DOF identification between sstruct parts (port of
hypre_tpu/sstruct/shared_dof.py; host numpy / scipy).

Reference: sstruct_ls/sstruct_sharedDOFComm.c — for node/edge/face
variables, DOFs on part boundaries coincide geometrically with DOFs of
neighboring parts and must be treated as ONE unknown; the reference
builds send/recv assumed-partition communication to agree on owners.

Parts live in one global index space (each part an
axis-aligned box at `origin`).  Every node/edge DOF gets a canonical
geometric KEY -- its DOUBLED global coordinate (nodes: 2*(origin+idx);
direction-d edges: doubled tail node + unit(d), so the odd component
encodes the direction).  np.unique over the concatenated keys yields
the global numbering and per-part local->global maps in one vectorized
pass; coincident boundary DOFs collapse automatically.  No
communication machinery is needed on a single address space -- the map
IS the exchange (gather/scatter by global id), which is also the form
a sharded implementation would consume (index maps feed scatters).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from ..utils.errors import arg_error


def _node_keys(shape, origin):
    nx, ny, nz = shape
    ox, oy, oz = origin
    gx, gy, gz = np.meshgrid(
        np.arange(nx + 1) + ox,
        np.arange(ny + 1) + oy,
        np.arange(nz + 1) + oz,
        indexing="ij",
    )
    # edge_structure numbers nodes in C-order of (nx+1, ny+1, nz+1)
    return np.stack(
        [2 * gx.ravel(), 2 * gy.ravel(), 2 * gz.ravel()], axis=1
    )


def _edge_keys(shape, origin):
    """Doubled midpoint keys in edge_structure's edge ordering
    (direction-major: all x-edges C-order, then y, then z)."""
    nx, ny, nz = shape
    NS = (nx + 1, ny + 1, nz + 1)
    keys = []
    for d in range(3):
        s = list(NS)
        s[d] -= 1
        gx, gy, gz = np.meshgrid(
            np.arange(s[0]) + origin[0],
            np.arange(s[1]) + origin[1],
            np.arange(s[2]) + origin[2],
            indexing="ij",
        )
        k = np.stack([2 * gx.ravel(), 2 * gy.ravel(), 2 * gz.ravel()], axis=1)
        k[:, d] += 1  # midpoint: tail + half a step along d
        keys.append(k)
    return np.concatenate(keys, axis=0)


def identify_dofs(keys_per_part):
    """Collapse geometrically coincident DOFs across parts.

    keys_per_part: list of int arrays [n_p, 3].  Returns (maps, n_glob):
    maps[p][l] = global id of part p's local DOF l; ids are assigned in
    lexicographic key order (deterministic, part-independent)."""
    sizes = [len(k) for k in keys_per_part]
    allk = np.concatenate(keys_per_part, axis=0)
    uniq, inv = np.unique(allk, axis=0, return_inverse=True)
    maps = []
    at = 0
    for s in sizes:
        maps.append(inv[at:at + s].astype(np.int64))
        at += s
    return maps, len(uniq)


def shared_node_edge_maps(shapes, origins):
    """Per-part local->global maps for NODE and EDGE variables of parts
    tiling a common index space.  Returns (node_maps, n_nodes, edge_maps,
    n_edges)."""
    nk = [_node_keys(s, o) for s, o in zip(shapes, origins)]
    ek = [_edge_keys(s, o) for s, o in zip(shapes, origins)]
    node_maps, nn = identify_dofs(nk)
    edge_maps, ne = identify_dofs(ek)
    return node_maps, nn, edge_maps, ne


# ---------------------------------------------------------------------------
# Rotated / mixed-orientation parts (sstruct_ls/maxwell_PNedelec.c +
# sstruct_grid.c MapIndex): each part carries a NeighborPart-style
# signed-permutation transform into the global frame.  Geometric keys are
# computed in the GLOBAL frame, so coincident DOFs of differently-oriented
# parts still collapse; edge DOFs whose tangential direction REVERSES
# under the transform pick up sign -1 (a Nedelec edge value is a
# circulation — reversing the edge flips it).
# ---------------------------------------------------------------------------


def _transform_doubled(keys, coord, dirs, origin):
    """Map doubled-coordinate keys through the signed permutation:
    out[coord[d]] = 2*origin[coord[d]] + dirs[d] * keys[:, d].
    `origin` is the (undoubled) global position of the part's local
    (0,0,0) node image; with dirs[d] = -1 the part's axis-d extent runs
    backwards from there, exactly hypre's index_map/index_dir
    semantics (sstruct_grid.c hypre_SStructNeighborMapIndex)."""
    keys = np.asarray(keys)
    out = np.zeros_like(keys)
    for d in range(3):
        out[:, coord[d]] = 2 * origin[coord[d]] + dirs[d] * keys[:, d]
    return out


def _edge_dir_counts(shape):
    """Edge count per direction for `shape` cells (edge_structure
    ordering: all x-edges, then y, then z)."""
    NS = (shape[0] + 1, shape[1] + 1, shape[2] + 1)
    counts = []
    for d in range(3):
        s = list(NS)
        s[d] -= 1
        counts.append(int(np.prod(s)))
    return counts


def _face_keys(shape):
    """Doubled face-center keys in edge_structure's face ordering
    (normal-direction-major: all x-normal faces C-order, then y, then
    z).  A face normal to d spans the two other axes — its doubled
    center is odd along those and even along d."""
    nx, ny, nz = shape
    NS = (nx + 1, ny + 1, nz + 1)
    keys = []
    for d in range(3):
        s = list(NS)
        for t in range(3):
            if t != d:
                s[t] -= 1
        gx, gy, gz = np.meshgrid(
            np.arange(s[0]), np.arange(s[1]), np.arange(s[2]),
            indexing="ij",
        )
        k = np.stack([2 * gx.ravel(), 2 * gy.ravel(), 2 * gz.ravel()],
                     axis=1)
        for t in range(3):
            if t != d:
                k[:, t] += 1
        keys.append(k)
    return np.concatenate(keys, axis=0)


def partition_of_unity_weights(shapes, transforms):
    """Per-part face and edge weights 1/multiplicity in the GLOBAL
    frame: each geometric object's total weight across the parts
    sharing it is exactly 1, so weighted per-part operators subassemble
    to the single-domain operator EXACTLY for ANY part orientations
    (the role ownership weighting plays for axis-aligned tilings in
    curlcurl_matrix_part — multiplicity is orientation-agnostic).
    Returns (wf_per_part, we_per_part)."""
    fk = [
        _transform_doubled(_face_keys(s), c, d, o)
        for s, (o, c, d) in zip(shapes, transforms)
    ]
    ek = [
        _transform_doubled(_edge_keys(s, (0, 0, 0)), c, d, o)
        for s, (o, c, d) in zip(shapes, transforms)
    ]

    def inv_mult(keys_per_part):
        maps, n = identify_dofs(keys_per_part)
        counts = np.zeros(n, dtype=np.int64)
        for m in maps:
            np.add.at(counts, m, 1)
        return [1.0 / counts[m] for m in maps]

    return inv_mult(fk), inv_mult(ek)


def shared_node_edge_maps_transformed(shapes, transforms):
    """Per-part local->global maps + EDGE SIGNS for parts placed in the
    global frame by signed-permutation transforms.

    transforms[p] = (origin, coord, dirs): local index i maps to global
    g with g[coord[d]] = origin[coord[d]] + dirs[d] * i[d].  Returns
    (node_maps, n_nodes, edge_maps, n_edges, edge_signs) where
    edge_signs[p][l] = +-1, the orientation of part p's local edge l
    relative to the canonical global edge (global edges point along
    +axis)."""
    nk, ek, es = [], [], []
    for s, (origin, coord, dirs) in zip(shapes, transforms):
        zero = (0, 0, 0)
        nk.append(_transform_doubled(_node_keys(s, zero), coord, dirs,
                                     origin))
        ek.append(_transform_doubled(_edge_keys(s, zero), coord, dirs,
                                     origin))
        counts = _edge_dir_counts(s)
        es.append(np.concatenate([
            np.full(counts[d], dirs[d], dtype=np.int8) for d in range(3)
        ]))
    node_maps, nn = identify_dofs(nk)
    edge_maps, ne = identify_dofs(ek)
    return node_maps, nn, edge_maps, ne, es


def subassemble_signed(mats, maps, signs, n_glob):
    """A_glob = sum_p (D_p S_p)^T A_p (D_p S_p) with D_p = diag(signs):
    the signed FEM subassembly for orientation-flipped edge DOFs."""
    import scipy.sparse as _sp

    out = None
    for A, m, sg in zip(mats, maps, signs):
        Ac = A.tocoo() if hasattr(A, "tocoo") else A.to_scipy().tocoo()
        sg = np.asarray(sg, dtype=Ac.data.dtype)
        G = _sp.coo_matrix(
            (Ac.data * sg[Ac.row] * sg[Ac.col],
             (m[Ac.row], m[Ac.col])),
            shape=(n_glob, n_glob),
        )
        out = G if out is None else out + G
    out = out.tocsr()
    out.sum_duplicates()
    out.sort_indices()
    return out


def scatter_to_global_signed(vecs, maps, signs, n_glob, combine="add"):
    out = np.zeros(n_glob, dtype=np.asarray(vecs[0]).dtype)
    for v, m, sg in zip(vecs, maps, signs):
        sv = np.asarray(v) * np.asarray(sg, dtype=out.dtype)
        if combine == "add":
            np.add.at(out, m, sv)
        else:
            out[m] = sv
    return out


def canonicalize_edge_maps(emaps, ne, global_shape):
    """Compose identify_dofs' lexicographic-key global edge numbering
    into edge_structure's CANONICAL numbering of the global box
    (direction-major, C-order tails), so subassembled operators index
    identically to G/P/C built by models/maxwell.edge_structure on
    `global_shape`.  Requires the parts to tile the box exactly (the
    union edge count must equal the box's edge count); raises
    ValueError otherwise."""
    emap_box, ne_box = identify_dofs([_edge_keys(global_shape, (0, 0, 0))])
    if ne != ne_box:
        raise arg_error(
            f"parts do not tile the global box {tuple(global_shape)}: "
            f"{ne} union edges vs {ne_box} box edges"
        )
    inv = np.empty(ne, dtype=np.int64)
    inv[emap_box[0]] = np.arange(ne, dtype=np.int64)
    return [inv[m] for m in emaps]


def subassemble(mats, maps, n_glob):
    """A_glob = sum_p S_p^T A_p S_p with S_p the local->global selection.

    Each part's matrix must hold only its OWNED contribution for shared
    entries (see models/maxwell.py curlcurl_matrix_part ownership
    weighting) -- then the sum reproduces the single-domain operator
    exactly, the FEM-subassembly identity the reference's shared-DOF
    layer maintains across ranks."""
    out = None
    for A, m in zip(mats, maps):
        Ac = A.tocoo() if hasattr(A, "tocoo") else A.to_scipy().tocoo()
        G = sp.coo_matrix(
            (Ac.data, (m[Ac.row], m[Ac.col])), shape=(n_glob, n_glob)
        )
        out = G if out is None else out + G
    out = out.tocsr()
    out.sum_duplicates()
    out.sort_indices()
    return out


def scatter_to_global(vecs, maps, n_glob, combine="add"):
    out = np.zeros(n_glob, dtype=np.asarray(vecs[0]).dtype)
    for v, m in zip(vecs, maps):
        if combine == "add":
            np.add.at(out, m, np.asarray(v))
        else:  # "set": owners agree on shared values
            out[m] = np.asarray(v)
    return out
