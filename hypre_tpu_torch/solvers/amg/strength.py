"""Strength-of-connection graph S (port of
hypre_tpu/solvers/amg/strength.py: strength_matrix,
strength_matrix_abs, second_strength).

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
