"""Galerkin coarse operator and its sparsifications (port of
hypre_tpu/solvers/amg/rap.py: galerkin_rap, nongalerkin_filter,
offset_budget_filter and its helper _lump_and_rebuild).

Reference: parcsr_ls/par_rap.c (A_H = P^T A P with R = P^T) via scipy's
CSR SpGEMM, and par_nongalerkin.c's role via the native kernel.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ... import native


def galerkin_rap(A: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    AP = A @ P
    RAP = P.T.tocsr() @ AP
    RAP.sort_indices()
    return RAP.tocsr()


def nongalerkin_filter(A: sp.csr_matrix, tol: float,
                       lump: str = "diag") -> sp.csr_matrix:
    """Drop |a_ij| < tol * sqrt(|a_ii a_jj|) (symmetrized) and lump the
    dropped mass so row sums are preserved: onto the diagonal ("diag")
    or over the row's kept off-diagonals by |value| ("strong")."""
    if tol <= 0:
        return A
    A = A.tocsr()
    A.sort_indices()
    return native.nongalerkin_filter_native(A, tol, lump)


def _lump_and_rebuild(A, keep, rows, cols, lump: str) -> sp.csr_matrix:
    """Drop the entries where ~keep, lumping the dropped mass so row sums
    are preserved ("diag" onto the diagonal, "strong" over the row's
    kept off-diagonals by |value|, par_nongalerkin.c's neighbour
    redistribution; a row with none lumps onto the diagonal), then
    rebuild canonical CSR."""
    n = A.shape[0]
    dropped = ~keep
    dropped_sum = np.bincount(
        rows[dropped], weights=A.data[dropped], minlength=n
    ).astype(A.data.dtype)
    redist_data = A.data.copy()
    if lump == "strong":
        keep_off = keep & (rows != cols)
        wsum = np.bincount(
            rows[keep_off], weights=np.abs(A.data[keep_off]), minlength=n
        )
        has = wsum > 0
        frac = np.zeros_like(redist_data)
        frac[keep_off] = np.abs(A.data[keep_off]) / wsum[rows[keep_off]]
        add = dropped_sum[rows] * frac
        mask_rows = has[rows] & keep_off
        redist_data = np.where(mask_rows, redist_data + add, redist_data)
        dropped_sum = np.where(has, 0.0, dropped_sum)
    # rebuild CSR from the kept entries (rows stay sorted)
    new_indptr = np.zeros(n + 1, dtype=A.indptr.dtype)
    kept_per_row = np.add.reduceat(
        keep.astype(np.int64), np.minimum(A.indptr[:-1], max(A.nnz - 1, 0))
    ) * (np.diff(A.indptr) > 0)
    np.cumsum(kept_per_row, out=new_indptr[1:])
    out = sp.csr_matrix(
        (redist_data[keep], cols[keep], new_indptr), shape=A.shape
    )
    out = out + sp.diags(dropped_sum)
    out.sort_indices()
    return out.tocsr()


def offset_budget_filter(A: sp.csr_matrix, pos, budget: int,
                         lump: str = "strong") -> sp.csr_matrix:
    """A relocated coarse operator sparsified to its `budget` heaviest
    lattice diagonals (the relocated levels' relocate_offset_budget, off
    by default).  The offsets are pos[j] - pos[i] of each entry; the
    offsets of most |value| mass are kept, an offset together with its
    negative, the diagonal always; the dropped mass is lumped
    row-sum-preservingly (`_lump_and_rebuild`).  It sparsifies the
    solve-phase operator only: the coarser Galerkin products are built
    from the unfiltered one."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    pos = np.asarray(pos, dtype=np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    cols = A.indices
    offs = pos[cols] - pos[rows]
    uoff, inv = np.unique(offs, return_inverse=True)
    if budget <= 0 or len(uoff) <= budget:
        return A
    mass = np.bincount(inv, weights=np.abs(A.data))
    # an offset and its negative are kept or dropped together
    neg = np.searchsorted(uoff, -uoff)
    has_neg = (neg < len(uoff)) & (uoff[np.minimum(neg, len(uoff) - 1)] == -uoff)
    pair_mass = mass + np.where(has_neg, mass[np.minimum(neg, len(uoff) - 1)], 0.0)
    order = np.argsort(-pair_mass, kind="stable")
    kept = np.zeros(len(uoff), dtype=bool)
    zero_at = np.searchsorted(uoff, 0)
    count = 0
    if zero_at < len(uoff) and uoff[zero_at] == 0:
        kept[zero_at] = True
        count = 1
    for oi in order:
        if count >= budget:
            break
        if kept[oi]:
            continue
        kept[oi] = True
        count += 1
        if has_neg[oi] and not kept[neg[oi]]:
            kept[neg[oi]] = True
            count += 1
    keep = kept[inv] | (rows == cols)
    return _lump_and_rebuild(A, keep, rows, cols, lump)
