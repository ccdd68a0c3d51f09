"""Classical and extended+i interpolation, and their truncation (port
of hypre_tpu/solvers/amg/interp.py: classical_interp, extended_i_interp,
truncate_interp, _rescale_rows).

Reference: parcsr_ls/par_interp.c (modified classical, interp_type 0),
par_lr_interp.c (extended+i, interp_type 6), both filled by the port's
native kernels, and hypre_ParCSRMatrixTruncate (par_csr_matrix.c:2671:
drop below tol*max|row|, cap at max_elmts largest-|.| in qsort2_abs tie
order, rescale to preserve row sums).

Unlike the JAX package, each interpolation has only its native path:
the port requires its own C library (hypre_tpu_torch/native), so the
JAX package's vectorized-scipy fallback of extended+i is not ported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ... import native


def _coo(vals, rows, cols, shape):
    M = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
    M.sum_duplicates()
    return M


def classical_interp(
    A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray
) -> sp.csr_matrix:
    """Modified classical interpolation (hypre interp_type 0)."""
    cmap = np.cumsum(np.asarray(cf) > 0) - 1
    return native.classical_interp_fill(A, S, cf, cmap)


def extended_i_interp(
    A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray
) -> sp.csr_matrix:
    """Extended+i interpolation (hypre interp_type 6).  The kernel
    counts cf >= 0 as C (classical_interp: cf > 0); PMIS marks no point
    0, so both read the same split."""
    rows, cols, vals = native.ext_pi_interp(A, S, cf)
    nc = int((np.asarray(cf) >= 0).sum())
    P = _coo(vals, rows, cols, (A.shape[0], nc))
    P.sort_indices()
    return P


def truncate_interp(
    P: sp.csr_matrix, trunc_factor: float = 0.0, max_elmts: int = 0
) -> sp.csr_matrix:
    """hypre_ParCSRMatrixTruncate semantics (rescale=1, inf-norm):
    phase 1 drops |v| < tol * max|row| (rescale to preserve row sum),
    phase 2 keeps the max_elmts largest-|.| (rescale again)."""
    if trunc_factor <= 0.0 and max_elmts == 0:
        return P
    P = P.tocsr()
    n = P.shape[0]
    rows = np.repeat(np.arange(n), np.diff(P.indptr))
    cols, vals = P.indices.copy(), P.data.copy()

    if trunc_factor > 0 and vals.size:
        rowmax = np.zeros(n)
        np.maximum.at(rowmax, rows, np.abs(vals))
        keep = np.abs(vals) >= trunc_factor * rowmax[rows]
        rows, cols, vals = _rescale_rows(rows, cols, vals, keep, n)

    if max_elmts > 0 and vals.size:
        indptr2 = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr2, rows + 1, 1)
        np.cumsum(indptr2, out=indptr2)
        keep = native.trunc_keep(indptr2, cols, vals, max_elmts)
        rows, cols, vals = _rescale_rows(rows, cols, vals, keep, n)

    return _coo(vals, rows, cols, P.shape)


def _rescale_rows(rows, cols, vals, keep, n):
    """Drop ~keep entries; scale kept so each row sum is preserved."""
    row_sum = np.zeros(n)
    np.add.at(row_sum, rows, vals)
    kept_sum = np.zeros(n)
    np.add.at(kept_sum, rows[keep], vals[keep])
    scale = np.where(kept_sum != 0, row_sum / np.where(kept_sum == 0, 1, kept_sum), 1.0)
    rows2, cols2 = rows[keep], cols[keep]
    vals2 = vals[keep] * scale[rows2]
    return rows2, cols2, vals2
