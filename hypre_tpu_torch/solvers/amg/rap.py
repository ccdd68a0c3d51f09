"""Galerkin coarse operator and non-Galerkin sparsification (port of
hypre_tpu/solvers/amg/rap.py: galerkin_rap, nongalerkin_filter).

Reference: parcsr_ls/par_rap.c (A_H = P^T A P with R = P^T) via scipy's
CSR SpGEMM, and par_nongalerkin.c's role via the native kernel.
"""

from __future__ import annotations

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
