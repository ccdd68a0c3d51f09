"""Pattern products, A A^T and the CF block split (port of
hypre_tpu/ops/matops.py: bool_multiply, aat, fffc_split).

Reference: parcsr_mv/par_csr_bool_matop.c (pattern-only products),
par_csr_aat.c (A A^T), gen_fffc.c (the FF / FC / CF / CC blocks).  Host
setup helpers in scipy; nothing on the solver path calls them.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def bool_multiply(A, B) -> sp.csr_matrix:
    """Pattern product: (A != 0) @ (B != 0) as a 0/1 CSR
    (hypre_ParBooleanMatmul)."""
    Ab = (A != 0).astype(np.int8)
    Bb = (B != 0).astype(np.int8)
    C = Ab @ Bb
    C.data[:] = 1
    return C.tocsr()


def aat(A) -> sp.csr_matrix:
    """A @ A^T with summed duplicates and sorted indices (hypre_ParAat)."""
    A = A.tocsr()
    C = (A @ A.T.tocsr()).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def fffc_split(A, cf: np.ndarray):
    """(A_FF, A_FC, A_CF, A_CC) of A split by the CF marker
    (hypre_ParCSRMatrixGenerateFFFC), rows and columns numbered in
    F-order / C-order (F: cf <= 0, C: cf > 0)."""
    A = A.tocsr()
    cf = np.asarray(cf)
    fidx = np.flatnonzero(cf <= 0)
    cidx = np.flatnonzero(cf > 0)
    AF = A[fidx]
    AC = A[cidx]
    return (AF[:, fidx].tocsr(), AF[:, cidx].tocsr(),
            AC[:, fidx].tocsr(), AC[:, cidx].tocsr())
