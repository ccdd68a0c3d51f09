"""Strength-of-connection graph S (port of
hypre_tpu/solvers/amg/strength.py: strength_matrix,
strength_matrix_abs, second_strength, create_nodal_A, gsmg_strength).

Reference: parcsr_ls/par_strength.c hypre_BoomerAMGCreateSHost:

  i depends on j  iff  a_ij < theta * min_{k != i} a_ik     (a_ii >= 0)
                  iff  a_ij > theta * max_{k != i} a_ik     (a_ii <  0)

plus the max_row_sum test: if |row_sum| > |a_ii| * max_row_sum (and
max_row_sum < 1), all dependencies of the row are made weak.  Host
setup, computed by the native kernel.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ... import native
from ...utils.lcg import lcg_fill


def strength_matrix(A, theta: float = 0.25,
                    max_row_sum: float = 0.9) -> sp.csr_matrix:
    """Boolean pattern CSR (data all 1.0), diagonal excluded.  Accepts
    a CSRMatrix or a scipy CSR."""
    M = A.to_scipy() if hasattr(A, "to_scipy") else A.tocsr()
    return native.strength_classical(M, theta, max_row_sum)


def second_strength(S: sp.csr_matrix, cf: np.ndarray,
                    num_paths: int = 1) -> sp.csr_matrix:
    """The strength graph among C points of the aggressive second
    round (par_strength.c hypre_BoomerAMGCreate2ndS:1724): the pattern
    of S S + 2 S restricted to C rows and columns, diagonal dropped, an
    entry kept where its path count reaches num_paths (a direct edge
    counts 2, so it survives num_paths 2).  Pattern CSR, data all 1.0."""
    idx = np.flatnonzero(cf > 0)
    Sb = S.copy().tocsr()
    Sb.data = np.ones_like(Sb.data)
    C = (Sb @ Sb + 2.0 * Sb).tocsr()[idx][:, idx].tocsr()
    C.setdiag(0)
    C.eliminate_zeros()
    if num_paths > 1:
        C.data = np.where(C.data >= num_paths, C.data, 0.0)
        C.eliminate_zeros()
    C.data = np.ones_like(C.data)
    C.sort_indices()
    return C


def strength_matrix_abs(A, theta: float = 0.25,
                        max_row_sum: float = 0.9) -> sp.csr_matrix:
    """Absolute-value strength (par_strength.c hypre_BoomerAMGCreateSabs):
    j strong iff |a_ij| > theta * max_{k != i} |a_ik|; with max_row_sum
    < 1 the diagonally dominant rows (sum |a_ij| < |a_ii| (2 -
    max_row_sum)) go weak.  Same pattern CSR as strength_matrix."""
    M = A.to_scipy() if hasattr(A, "to_scipy") else A.tocsr()
    return native.strength_classical(M, theta, max_row_sum, sabs=True)


def create_nodal_A(A: sp.csr_matrix, num_functions: int, option: int = 1,
                   diag_option: int = 0) -> sp.csr_matrix:
    """Nodal norm matrix for nodal-systems coarsening
    (par_nodal_systems.c hypre_BoomerAMGCreateNodalA:38): each
    num_functions x num_functions block collapses to a scalar norm.
      option 1: Frobenius   2: sum of |.|   3: the signed element of
      largest |.|   4: inf norm (the largest |.| row sum of the block,
      par_nodal_systems.c:330-343)   6: signed sum of all elements
    diag_option 1: diagonal = -(sum of the off-diagonal entries);
    diag_option 2: diagonal entries negated (par_nodal_systems.c:395).
    Interleaved unknowns (node = i // num_functions)."""
    nf = num_functions
    Ac = A.tocoo()
    nn = A.shape[0] // nf
    nr = Ac.row // nf
    ncol = Ac.col // nf
    mode = abs(option)
    if mode == 1:
        M = sp.csr_matrix((Ac.data**2, (nr, ncol)), shape=(nn, nn))
        M.sum_duplicates()
        M.data = np.sqrt(M.data)
    elif mode == 2:
        M = sp.csr_matrix((np.abs(Ac.data), (nr, ncol)), shape=(nn, nn))
        M.sum_duplicates()
    elif mode == 3:
        # the signed element of largest magnitude a block
        # (par_nodal_systems.c:295-297 keeps A_diag_data[k], not its
        # abs).  At equal magnitude with both signs the positive one
        # wins; negative only where no positive entry attains the max
        key = nr.astype(np.int64) * nn + ncol
        uk, inv = np.unique(key, return_inverse=True)
        mx = np.zeros(len(uk))
        np.maximum.at(mx, inv, np.abs(Ac.data))
        neg_at_max = np.zeros(len(uk), dtype=bool)
        pos_at_max = np.zeros(len(uk), dtype=bool)
        at_max = np.abs(Ac.data) == mx[inv]
        np.logical_or.at(neg_at_max, inv[at_max], Ac.data[at_max] < 0)
        np.logical_or.at(pos_at_max, inv[at_max], Ac.data[at_max] > 0)
        sign = np.where(neg_at_max & ~pos_at_max, -1.0, 1.0)
        M = sp.csr_matrix(
            (sign * mx,
             ((uk // nn).astype(np.int64), (uk % nn).astype(np.int64))),
            shape=(nn, nn),
        )
    elif mode == 6:
        M = sp.csr_matrix((Ac.data, (nr, ncol)), shape=(nn, nn))
        M.sum_duplicates()
    else:
        # mode 4: the block inf norm, the largest of the per-function
        # row |.| sums (the reference sums data[.., j] per function row
        # j, then takes hypre_max over j)
        key = (nr.astype(np.int64) * nn + ncol) * nf + (Ac.row % nf)
        uk, inv = np.unique(key, return_inverse=True)
        rowsum = np.zeros(len(uk))
        np.add.at(rowsum, inv, np.abs(Ac.data))
        blk = uk // nf
        ub, binv = np.unique(blk, return_inverse=True)
        mx = np.zeros(len(ub))
        np.maximum.at(mx, binv, rowsum)
        M = sp.csr_matrix(
            (mx, ((ub // nn).astype(np.int64), (ub % nn).astype(np.int64))),
            shape=(nn, nn),
        )
    M = M.tocsr()
    M.sort_indices()
    if diag_option == 1:
        off = M - sp.diags(M.diagonal())
        M = (off + sp.diags(-np.asarray(off.sum(axis=1)).ravel())).tocsr()
    elif diag_option == 2:
        M = (M - 2.0 * sp.diags(M.diagonal())).tocsr()
    return M


def gsmg_strength(A, nsamples: int = 5, nu: int = 5, seed: int = 2747,
                  dof_func=None) -> sp.csr_matrix:
    """GSMG smoothed-vector strength (par_gsmg.c:54
    hypre_ParCSRMatrixFillSmooth, ChooseThresh:250, Threshold:287).

    Relax nsamples random vectors (hypre's LCG from `seed`) nu times by
    weighted Jacobi (2/3) on the homogeneous system, scale each to
    norm 1 / nsamples, set S_ij = 1 / sum_k |p_k(i) - p_k(j)| on A's
    nonzero off-diagonal same-function pattern, then keep the entries
    at or above the minimax threshold (the least row maximum).  Pattern
    CSR, data all 1.0."""
    M = A.to_scipy() if hasattr(A, "to_scipy") else A.tocsr()
    n = M.shape[0]
    diag = M.diagonal()
    dsafe = np.where(diag == 0, 1.0, diag)

    samples = np.empty((nsamples, n))
    skip = 0
    for k in range(nsamples):
        e = 2.0 * lcg_fill(seed, n, skip) - 1.0
        skip += n
        for _ in range(nu):
            e = e - (2.0 / 3.0) * ((M @ e) / dsafe)
        samples[k] = e
    nrm = np.linalg.norm(samples, axis=1)
    samples /= np.where(nrm == 0, 1.0, nrm)[:, None] * nsamples

    Mc = M.tocoo()
    offd = Mc.row != Mc.col
    same = (
        np.ones(Mc.nnz, bool)
        if dof_func is None
        else np.asarray(dof_func)[Mc.row] == np.asarray(dof_func)[Mc.col]
    )
    sel = offd & same & (Mc.data != 0)
    dsum = np.zeros(Mc.nnz)
    for k in range(nsamples):
        dsum[sel] += np.abs(samples[k][Mc.row[sel]] - samples[k][Mc.col[sel]])
    vals = np.zeros(Mc.nnz)
    ok = sel & (dsum > 0)
    vals[ok] = 1.0 / dsum[ok]

    Sv = sp.csr_matrix((vals, (Mc.row, Mc.col)), shape=(n, n))
    Sv.eliminate_zeros()
    rows = np.repeat(np.arange(n), np.diff(Sv.indptr))
    rowmax = np.zeros(n)
    if Sv.nnz:
        np.maximum.at(rowmax, rows, Sv.data)
    nzrows = rowmax > 0
    thresh = rowmax[nzrows].min() if nzrows.any() else 0.0
    keep = Sv.data >= thresh
    S = sp.csr_matrix(
        (np.ones(int(keep.sum())), (rows[keep], Sv.indices[keep])), shape=(n, n)
    )
    S.sort_indices()
    return S
