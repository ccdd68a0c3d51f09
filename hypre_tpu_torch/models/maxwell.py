"""Structured edge-element (Nedelec-0) and face-element (RT0) problem
generators (port of hypre_tpu/models/maxwell.py).

Reference analog: test/ams_driver.c builds curl-curl + mass systems with
a discrete gradient; sstruct_ls/maxwell_grad.c builds G from grid
topology.  Here: incidence matrices of a uniform hex lattice.

Unknowns: edges of an (nx+1)x(ny+1)x(nz+1) node lattice (x-, y-,
z-directed), nodes for the gradient space, faces for the curl.
A = alpha * C^T C + beta * M_e  (curl-curl plus lumped edge mass).
Host numpy / scipy, line for line the JAX package's, so both build the
same matrices bit for bit; with the part-local curl-curl operators of
the multi-part sstruct Maxwell solver (`curlcurl_matrix_part`,
`curlcurl_matrix_part_weighted`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..ops.csr import CSRMatrix


def _node_id(shape):
    return np.arange(np.prod(shape)).reshape(shape)


def edge_structure(nx, ny, nz, h=1.0):
    """Returns (G, C, coords, n_edges): discrete gradient (edges x nodes,
    +1 head / -1 tail), discrete curl (faces x edges), node coords."""
    NS = (nx + 1, ny + 1, nz + 1)
    nid = _node_id(NS)
    nn = nid.size

    # edges per direction: head = node + unit(d)
    def edges_dir(d):
        sl_t = [slice(None)] * 3
        sl_h = [slice(None)] * 3
        sl_t[d] = slice(0, NS[d] - 1)
        sl_h[d] = slice(1, NS[d])
        tails = nid[tuple(sl_t)].ravel()
        heads = nid[tuple(sl_h)].ravel()
        return tails, heads

    tails, heads, edir = [], [], []
    for d in range(3):
        t, hd = edges_dir(d)
        tails.append(t)
        heads.append(hd)
        edir.append(np.full(len(t), d))
    tails = np.concatenate(tails)
    heads = np.concatenate(heads)
    edir = np.concatenate(edir)
    ne = len(tails)

    rows = np.repeat(np.arange(ne), 2)
    cols = np.stack([heads, tails], axis=1).ravel()
    vals = np.tile([1.0, -1.0], ne)
    G = sp.coo_matrix((vals, (rows, cols)), shape=(ne, nn)).tocsr()

    # edge lookup tables per direction for face assembly
    def edge_index_array(d):
        shape = list(NS)
        shape[d] -= 1
        offset = 0
        for dd in range(d):
            s = list(NS)
            s[dd] -= 1
            offset += int(np.prod(s))
        return offset + np.arange(int(np.prod(shape))).reshape(shape)

    E = [edge_index_array(d) for d in range(3)]

    # faces normal to direction d use edges in the two other directions
    faces_rows, faces_cols, faces_vals = [], [], []
    fcount = 0
    for d in range(3):
        d1, d2 = [x for x in range(3) if x != d]
        fshape = list(NS)
        fshape[d1] -= 1
        fshape[d2] -= 1
        nf = int(np.prod(fshape))
        fid = np.arange(nf).reshape(fshape) + fcount
        # face loop: +e1(at low d2) +e2(at high d1) -e1(at high d2) -e2(at low d1)
        idx = np.indices(fshape)

        e1_lo = E[d1][tuple(idx)]
        e2_hi_coords = [idx[k].copy() for k in range(3)]
        e2_hi_coords[d1] += 1
        e2_hi = E[d2][tuple(e2_hi_coords)]
        e1_hi_coords = [idx[k].copy() for k in range(3)]
        e1_hi_coords[d2] += 1
        e1_hi = E[d1][tuple(e1_hi_coords)]
        e2_lo = E[d2][tuple(idx)]
        for earr, sgn in ((e1_lo, 1.0), (e2_hi, 1.0), (e1_hi, -1.0), (e2_lo, -1.0)):
            faces_rows.append(fid.ravel())
            faces_cols.append(earr.ravel())
            faces_vals.append(np.full(nf, sgn))
        fcount += nf

    C = sp.coo_matrix(
        (
            np.concatenate(faces_vals),
            (np.concatenate(faces_rows), np.concatenate(faces_cols)),
        ),
        shape=(fcount, ne),
    ).tocsr()

    gx, gy, gz = np.meshgrid(
        np.arange(NS[0]) * h, np.arange(NS[1]) * h, np.arange(NS[2]) * h,
        indexing="ij",
    )
    coords = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)
    return CSRMatrix.from_scipy(G), CSRMatrix.from_scipy(C), coords, ne


def curlcurl_matrix(nx, ny, nz, alpha=1.0, beta=1.0, h=1.0):
    """A = alpha C^T C + beta M_e (lumped edge mass = h * I scaled)."""
    G, C, coords, ne = edge_structure(nx, ny, nz, h)
    Cs = C.to_scipy()
    A = alpha * (Cs.T @ Cs) + beta * sp.eye(ne)
    A = A.tocsr()
    A.sort_indices()
    return CSRMatrix.from_scipy(A), G, coords


def curlcurl_matrix_part(shape, origin, global_shape, alpha=1.0,
                         beta=1.0, h=1.0):
    """Part-local curl-curl contribution with OWNERSHIP weighting.

    Parts tiling a global box share the faces and edges on their
    interfaces; summing naive per-part operators through the shared-DOF
    maps (sstruct/shared_dof.py) would double-count them.  Ownership
    assigns every face/edge to exactly one part -- the part whose
    half-open cell box contains its anchor cell (node-aligned axes
    clamp to the global cell range, so global-boundary objects belong
    to the last part touching them).  Then
        sum_p S_p^T A_p S_p == curlcurl_matrix(global_shape)
    EXACTLY (the FEM-subassembly identity the reference's shared-DOF
    layer maintains across ranks; maxwell_TV_setup.c assembles the
    parallel edge system the same way).
    """
    nx, ny, nz = shape
    G, C, coords, ne = edge_structure(nx, ny, nz, h)
    NS = (nx + 1, ny + 1, nz + 1)

    def own_weights(shapes_reduce):
        """shapes_reduce: per direction d, which axes are cell-aligned
        (reduced by 1)."""
        ws = []
        for d in range(3):
            lat = list(NS)
            cell_axes = shapes_reduce(d)
            for ax in cell_axes:
                lat[ax] -= 1
            idx = np.indices(lat)
            own = np.ones(lat, dtype=bool)
            for ax in range(3):
                g = idx[ax] + origin[ax]
                if ax in cell_axes:
                    anchor = g
                else:
                    anchor = np.minimum(g, global_shape[ax] - 1)
                own &= (anchor >= origin[ax]) & (
                    anchor < origin[ax] + shape[ax]
                )
            ws.append(own.ravel())
        return np.concatenate(ws).astype(np.float64)

    # faces normal to d are cell-aligned on the two other axes
    wf = own_weights(lambda d: [x for x in range(3) if x != d])
    # direction-d edges are cell-aligned on d only
    we = own_weights(lambda d: [d])
    Cs = C.to_scipy()
    A = alpha * (Cs.T @ sp.diags(wf) @ Cs) + beta * sp.diags(we)
    A = A.tocsr()
    A.sort_indices()
    return CSRMatrix.from_scipy(A), G, coords


def curlcurl_matrix_part_weighted(shape, wf, we, alpha=1.0, beta=1.0,
                                  h=1.0):
    """Part-local curl-curl with CALLER-SUPPLIED face/edge weights:
    A_p = alpha C^T diag(wf) C + beta diag(we).

    With wf/we = 1/multiplicity in the global frame
    (sstruct/shared_dof.py partition_of_unity_weights), the signed
    subassembly over arbitrarily ORIENTED parts reproduces
    curlcurl_matrix(global) exactly — the orientation-agnostic
    generalization of curlcurl_matrix_part's ownership weighting
    (reference: maxwell_TV_setup.c parallel assembly +
    maxwell_PNedelec.c transformed-part handling)."""
    G, C, coords, ne = edge_structure(*shape, h)
    Cs = C.to_scipy()
    A = alpha * (Cs.T @ sp.diags(np.asarray(wf, np.float64)) @ Cs) \
        + beta * sp.diags(np.asarray(we, np.float64))
    A = A.tocsr()
    A.sort_indices()
    return CSRMatrix.from_scipy(A), G, coords


def face_structure(nx, ny, nz, h=1.0):
    """Face-element (RT0) structure: returns (C, Pi_rt, n_faces, G,
    coords) with C
    the discrete curl (faces x edges, from edge_structure) and Pi_rt the
    RT0 interpolation faces x 3*nodes (quarter weight per face corner in
    the face-normal component) — the hypre_ADSComputePi analog."""
    G, C, coords, ne = edge_structure(nx, ny, nz, h)
    NS = (nx + 1, ny + 1, nz + 1)
    nid = _node_id(NS)
    nn = nid.size

    rows_l, cols_l, vals_l = [], [], []
    fcount = 0
    for d in range(3):
        d1, d2 = [x for x in range(3) if x != d]
        fshape = list(NS)
        fshape[d1] -= 1
        fshape[d2] -= 1
        nf = int(np.prod(fshape))
        idx = np.indices(fshape)
        fid = np.arange(nf) + fcount
        # 4 corner nodes of each face (quad in the d1-d2 plane)
        for s1 in (0, 1):
            for s2 in (0, 1):
                cidx = [idx[k].copy() for k in range(3)]
                cidx[d1] += s1
                cidx[d2] += s2
                nodes = nid[tuple(cidx)].ravel()
                rows_l.append(fid)
                cols_l.append(nodes * 3 + d)  # normal component
                vals_l.append(np.full(nf, 0.25 * h * h))
        fcount += nf

    Pi = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(fcount, 3 * nn),
    ).tocsr()
    return C, CSRMatrix.from_scipy(Pi), fcount, G, coords


def divdiv_matrix(nx, ny, nz, alpha=1.0, beta=1.0, h=1.0):
    """A = alpha D^T D + beta M_f on faces (D = discrete divergence =
    cell-face incidence) — the ADS test problem."""
    C, Pi, nf, G, coords = face_structure(nx, ny, nz, h)
    # divergence: cells x faces; cell (i,j,k) touches 6 faces with signs
    NS = (nx + 1, ny + 1, nz + 1)
    ncell = nx * ny * nz
    cshape = (nx, ny, nz)
    cidx = np.indices(cshape)
    cell = np.arange(ncell)

    rows_l, cols_l, vals_l = [], [], []
    foffset = 0
    for d in range(3):
        d1, d2 = [x for x in range(3) if x != d]
        fshape = list(NS)
        fshape[d1] -= 1
        fshape[d2] -= 1

        # face index arrays ordered over fshape (NS with the two
        # tangential dims reduced), matching edge_structure's face ids
        farr = np.arange(int(np.prod(fshape))).reshape(fshape)
        lo = farr[tuple([cidx[k] for k in range(3)])]
        hic = [cidx[k].copy() for k in range(3)]
        hic[d] += 1
        hi = farr[tuple(hic)]
        rows_l += [cell, cell]
        cols_l += [foffset + lo.ravel(), foffset + hi.ravel()]
        vals_l += [np.full(ncell, -1.0), np.full(ncell, 1.0)]
        foffset += int(np.prod(fshape))

    D = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(ncell, nf),
    ).tocsr()
    A = (alpha * (D.T @ D) + beta * sp.eye(nf)).tocsr()
    A.sort_indices()
    return CSRMatrix.from_scipy(A), C, Pi, G, coords
