"""Interpolation P, AIR restriction R and their truncation (port of
hypre_tpu/solvers/amg/interp.py: classical_interp, direct_interp,
extended_i_interp, multipass_interp, standard_interp, ff_interp,
extended_interp, jacobi_interp, air_restriction, truncate_interp,
interp_vec_modify and the helpers _split, _coo, _csr_lookup, _pattern_mask, _rescale_rows).

Reference: parcsr_ls/par_interp.c (modified classical, interp_type 0,
and direct, 3), par_lr_interp.c (extended+i 6, standard 8 / 9, FF 12,
FF1 13, extended 14), par_multi_interp.c (multipass, the aggressive
default), par_jacobi_interp.c (post_interp_type), par_restr.c /
par_lr_restr.c (AIR, restrict_type 1 / 2), and
par_sv_interp.c's role (interp_vec_modify, the GM / LN variants), and
hypre_ParCSRMatrixTruncate (par_csr_matrix.c:2671: drop below
tol*max|row|, cap at max_elmts largest-|.| in qsort2_abs tie order,
rescale to preserve row sums).  Classical and extended+i are filled by
the port's native kernels; the others are vectorized scipy, the same
arithmetic as the JAX package's.

Unlike the JAX package, classical and extended+i have only their native
path: the port requires its own C library (hypre_tpu_torch/native), so
the JAX package's vectorized-scipy fallbacks of those are not ported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ... import native
from .coarsen import C_PT, F_PT


def _split(A: sp.csr_matrix):
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    return n, rows, A.indices, A.data


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


def direct_interp(
    A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray
) -> sp.csr_matrix:
    """Direct interpolation (hypre interp_type 3, par_interp.c:1474-1700):
    P_ij = -alfa * a_ij / a_ii  (a_ij < 0),  -beta * a_ij / a_ii (a_ij > 0)
    alfa = sum_all-neg / sum_strongC-neg, beta likewise for positive."""
    n, rows, cols, data = _split(A)
    diag = A.diagonal()
    is_c = cf > 0
    cmap = np.cumsum(is_c) - 1
    nc = int(is_c.sum())
    strong_pairs = _pattern_mask(A, S)
    strongC = strong_pairs & is_c[cols]
    offdiag = cols != rows

    neg = data < 0
    pos = (data > 0) & offdiag

    sum_N_neg = np.zeros(n)
    sum_N_pos = np.zeros(n)
    sum_P_neg = np.zeros(n)
    sum_P_pos = np.zeros(n)
    np.add.at(sum_N_neg, rows[neg & offdiag], data[neg & offdiag])
    np.add.at(sum_N_pos, rows[pos], data[pos])
    np.add.at(sum_P_neg, rows[strongC & neg], data[strongC & neg])
    np.add.at(sum_P_pos, rows[strongC & pos], data[strongC & pos])

    alfa = np.divide(sum_N_neg, sum_P_neg, out=np.zeros(n), where=sum_P_neg != 0)
    beta = np.divide(sum_N_pos, sum_P_pos, out=np.zeros(n), where=sum_P_pos != 0)

    coef = np.where(data < 0, alfa[rows], beta[rows])
    sel = strongC & ~is_c[rows]
    p_vals = -coef[sel] * data[sel] / diag[rows[sel]]

    c_idx = np.flatnonzero(is_c)
    P = _coo(
        np.concatenate([p_vals, np.ones(nc)]),
        np.concatenate([rows[sel], c_idx]),
        np.concatenate([cmap[cols[sel]], cmap[c_idx]]),
        (n, nc),
    )
    P.sort_indices()
    return P


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


def _csr_lookup(M: sp.csr_matrix, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Values M[rows[i], cols[i]] (0 where absent) via sorted-key search —
    O((nnz+q) log nnz), much faster than scipy fancy indexing."""
    if rows.size == 0:
        return np.zeros(0)
    n = M.shape[1]
    m_rows = np.repeat(np.arange(M.shape[0], dtype=np.int64), np.diff(M.indptr))
    keys_m = m_rows * n + M.indices  # ascending for sorted-indices CSR
    keys_q = rows.astype(np.int64) * n + cols
    pos = np.searchsorted(keys_m, keys_q)
    pos_c = np.clip(pos, 0, len(keys_m) - 1)
    hit = (len(keys_m) > 0) & (keys_m[pos_c] == keys_q)
    return np.where(hit, M.data[pos_c], 0.0)


def _pattern_mask(A: sp.csr_matrix, S: sp.csr_matrix) -> np.ndarray:
    """Boolean per-A-entry mask: True where (row, col) is in S's pattern."""
    if A.nnz == 0:
        return np.zeros(0, dtype=bool)
    n = A.shape[0]
    rows_a = np.repeat(np.arange(n), np.diff(A.indptr))
    key_a = rows_a.astype(np.int64) * n + A.indices
    rows_s = np.repeat(np.arange(n), np.diff(S.indptr))
    key_s = rows_s.astype(np.int64) * n + S.indices
    key_s_sorted = np.sort(key_s)
    pos = np.searchsorted(key_s_sorted, key_a)
    pos = np.clip(pos, 0, len(key_s_sorted) - 1)
    return (len(key_s_sorted) > 0) & (key_s_sorted[pos] == key_a)


def multipass_interp(
    A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray, max_passes: int = 10
) -> sp.csr_matrix:
    """Stuben's direct interpolation with multiple passes
    (par_multi_interp.c hypre_BoomerAMGBuildMultipass:16; the default
    interpolation for aggressive coarsening, agg_interp_type 4).

    Pass assignment (par_multi_interp.c:473-596): pass-1 F points have a
    strong C neighbor; pass-p points have a strong neighbor assigned
    p-1.  Pass-1 weights are the sign-split direct formula
    (:1210-1292): P_ij = alfa*a_ij (a_ij<0) / beta*a_ij (a_ij>0) with
    alfa = -sum_N_neg/(sum_C_neg*a_ii), beta likewise for positive
    parts, where sum_N runs over ALL off-diagonal entries with
    CF != -3 and sum_C over the interpolatory set.  Pass-p weights
    (:1404-1550) accumulate a_ij * P[j,:] over strong pass-(p-1)
    neighbors j (sign-split sums per CONTRIBUTION), other entries go to
    sum_N, then the same alfa/beta rescale.

    Vectorized: each pass is two sign-split sparse matmuls over the
    frontier rows.
    """
    n = A.shape[0]
    is_c = cf == C_PT
    is_sf = cf == -3
    nc = int(is_c.sum())
    f2c = np.cumsum(is_c) - 1

    diag = A.diagonal()
    Aoff = A - sp.diags(diag)
    Aoff.eliminate_zeros()
    Spat = S.copy()
    Spat.data = np.ones_like(Spat.data)

    # sum_N per row: all off-diag entries with CF[col] != -3, sign-split
    Aneg = Aoff.minimum(0).tocsr()
    Apos = Aoff.maximum(0).tocsr()
    keepN = (~is_sf).astype(A.dtype)
    sum_N_neg_all = Aneg @ keepN
    sum_N_pos_all = Apos @ keepN

    # pass assignment; Pcur accumulates finalized rows (C rows: identity)
    assigned = np.full(n, -1, dtype=np.int64)
    assigned[is_c] = 0
    crows = np.flatnonzero(is_c)
    Pcur = sp.csr_matrix(
        (np.ones(nc), (crows, f2c[crows])), shape=(n, nc)
    )

    unassigned = (~is_c) & (~is_sf)
    for p in range(1, max_passes):
        prev_mask = (assigned == p - 1).astype(A.dtype)
        frontier = unassigned & (assigned < 0) & (np.asarray(Spat @ prev_mask).ravel() > 0)
        R = np.flatnonzero(frontier)
        if R.size == 0:
            break
        assigned[R] = p

        # mask of A entries (i in R, j strong with assigned == p-1)
        sel = sp.csr_matrix(
            (np.ones(R.size), (R, R)), shape=(n, n)
        )
        SR = (sel @ Spat) @ sp.diags(prev_mask)  # strong, prev-pass cols
        SR.eliminate_zeros()
        SR.data = np.ones_like(SR.data)
        A_R = sel @ Aoff
        A_sel = A_R.multiply(SR).tocsr()

        An = A_sel.minimum(0).tocsr()
        Ap = A_sel.maximum(0).tocsr()
        if p == 1:
            # direct: pattern = strong C entries themselves
            pos_mat = Ap @ sp.csr_matrix(
                (np.ones(nc), (crows, f2c[crows])), shape=(n, nc)
            )
            neg_mat = An @ sp.csr_matrix(
                (np.ones(nc), (crows, f2c[crows])), shape=(n, nc)
            )
        else:
            Ppos = Pcur.maximum(0).tocsr()
            Pneg = Pcur.minimum(0).tocsr()
            pos_mat = Ap @ Ppos + An @ Pneg
            neg_mat = Ap @ Pneg + An @ Ppos
        pos_mat = pos_mat.tocsr()
        neg_mat = neg_mat.tocsr()

        sum_C_neg = np.asarray(neg_mat.sum(axis=1)).ravel()[R]
        sum_C_pos = np.asarray(pos_mat.sum(axis=1)).ravel()[R]
        selN_neg = np.asarray(An.sum(axis=1)).ravel()[R]
        selN_pos = np.asarray(Ap.sum(axis=1)).ravel()[R]
        if p == 1:
            sum_N_neg = sum_N_neg_all[R]
            sum_N_pos = sum_N_pos_all[R]
        else:
            # contributions replace the raw a_ij for selected cols
            sum_N_neg = sum_N_neg_all[R] - selN_neg + sum_C_neg
            sum_N_pos = sum_N_pos_all[R] - selN_pos + sum_C_pos

        d = diag[R]
        with np.errstate(divide="ignore", invalid="ignore"):
            alfa = np.where(sum_C_neg * d != 0, -sum_N_neg / (sum_C_neg * d), 1.0)
            beta = np.where(sum_C_pos * d != 0, -sum_N_pos / (sum_C_pos * d), 1.0)

        alfa_full = np.ones(n)
        beta_full = np.ones(n)
        alfa_full[R] = alfa
        beta_full[R] = beta
        Prow = sp.diags(alfa_full) @ neg_mat + sp.diags(beta_full) @ pos_mat
        # keep only frontier rows
        Prow = sel @ Prow
        Pcur = Pcur + Prow.tocsr()

    Pcur = Pcur.tocsr()
    Pcur.sort_indices()
    return Pcur


def standard_interp(
    A: sp.csr_matrix, S: sp.csr_matrix, cf: np.ndarray, sep_weight: bool = False
) -> sp.csr_matrix:
    """Standard interpolation (par_lr_interp.c
    hypre_BoomerAMGBuildStdInterp:22, interp_type 8; sep_weight=True is
    type 9).

    For F point i, eliminate each strong-F neighbor j by distributing
    a_ij/a_jj times row j (diagonal of j skipped), drop direct entries
    to SF points, then
       P_ik = -alfa * ahat_ik,  alfa = sum(ahat_i)/sum_C(ahat_i)/ahat_ii
    over the distance-2 C pattern (strong C of i + strong C of strong-F
    neighbors); sep_weight splits the sums by sign (types 9).
    """
    n = A.shape[0]
    is_c = cf == C_PT
    is_sf = cf == -3
    nc = int(is_c.sum())
    f2c = np.cumsum(is_c) - 1
    f_rows = (~is_c) & (~is_sf)

    diag = A.diagonal()
    Spat = S.copy().tocsr()
    Spat.data = np.ones_like(Spat.data)

    # strong-F edge matrix with distribute weights a_ij / a_jj
    SF = (Spat @ sp.diags((f_rows).astype(float))).tocsr()
    SF.eliminate_zeros()
    E = SF.multiply(A).tocsr()  # a_ij at strong-F positions
    dsafe = np.where(diag == 0, 1.0, diag)
    E = (E @ sp.diags(1.0 / dsafe)).tocsr()  # d_ij = a_ij/a_jj

    Aoff = (A - sp.diags(diag)).tocsr()
    # direct part: A row minus strong-F entries minus entries to SF cols
    Adir = (A - SF.multiply(A)).tocsr()
    keep_cols = sp.diags((~is_sf).astype(float))
    Adir_off = ((Adir - sp.diags(Adir.diagonal())) @ keep_cols).tocsr()
    Ahat_off = (Adir_off - E @ Aoff).tocsr()  # off-diagonal slots
    # distributed contributions landing on column i belong to the
    # diagonal slot (hypre's ihat[i] bucket): fold and strip them
    Ahat_diag = diag + Ahat_off.diagonal()
    Ahat_off = (Ahat_off - sp.diags(Ahat_off.diagonal())).tocsr()

    # distance-2 C pattern
    Cmask = sp.diags(is_c.astype(float))
    SC = (Spat @ Cmask).tocsr()
    pat = (SC + SF @ SC).tocsr()
    pat.data = np.ones_like(pat.data)
    Fsel = sp.diags(f_rows.astype(float))
    pat = (Fsel @ pat).tocsr()

    Wc = Ahat_off.multiply(pat).tocsr()  # pattern (C-slot) values
    sum_all = np.asarray(Ahat_off.sum(axis=1)).ravel()
    sum_C = np.asarray(Wc.sum(axis=1)).ravel()
    dsafe2 = np.where(Ahat_diag == 0, 1.0, Ahat_diag)

    if not sep_weight:
        with np.errstate(divide="ignore", invalid="ignore"):
            alfa = np.where(
                (sum_C != 0) & (Ahat_diag != 0), sum_all / np.where(sum_C == 0, 1, sum_C) / dsafe2, 0.0
            )
        W = (sp.diags(-alfa) @ Wc).tocsr()
    else:
        Wp = Wc.maximum(0).tocsr()
        Wn = Wc.minimum(0).tocsr()
        pos_all = np.asarray(Ahat_off.maximum(0).sum(axis=1)).ravel()
        neg_all = np.asarray(Ahat_off.minimum(0).sum(axis=1)).ravel()
        pos_C = np.asarray(Wp.sum(axis=1)).ravel()
        neg_C = np.asarray(Wn.sum(axis=1)).ravel()
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.where((pos_C != 0) & (Ahat_diag != 0),
                            pos_all / np.where(pos_C == 0, 1, pos_C) / dsafe2, 0.0)
            alfa = np.where((neg_C != 0) & (Ahat_diag != 0),
                            neg_all / np.where(neg_C == 0, 1, neg_C) / dsafe2, 0.0)
        W = (sp.diags(-beta) @ Wp + sp.diags(-alfa) @ Wn).tocsr()

    Wcoo = W.tocoo()
    keep = f_rows[Wcoo.row] & is_c[Wcoo.col]
    rows = np.concatenate([Wcoo.row[keep], np.flatnonzero(is_c)])
    cols = np.concatenate([f2c[Wcoo.col[keep]], f2c[np.flatnonzero(is_c)]])
    vals = np.concatenate([Wcoo.data[keep], np.ones(nc)])
    P = _coo(vals, rows, cols, (n, nc))
    P.sort_indices()
    return P


def ff_interp(
    A: sp.csr_matrix,
    S: sp.csr_matrix,
    cf: np.ndarray,
    ff1: bool = False,
    common_c_gate: bool = True,
) -> sp.csr_matrix:
    """F-F interpolation (par_lr_interp.c hypre_BoomerAMGBuildFFInterp
    :2890, interp_type 12; ff1=True is BuildFF1Interp:3781, type 13).

    Pattern: strong C of i; for each strong-F neighbor i1 WITHOUT a
    common strong-C point with i, extend by i1's strong C points (FF1:
    only i1's first such point).  Weights: extended-interp distribution
    (sign-filtered sums over the row pattern, no "+i" term); strong-F
    neighbors with zero distribution sum and weak entries (CF != -3)
    lump into the diagonal.
    """
    n, rows, cols, data = _split(A)
    diag = A.diagonal()
    is_c = cf > 0
    cmap = np.cumsum(is_c) - 1
    nc = int(is_c.sum())
    f_rows = (~is_c) & (cf != -3)

    strong_pairs = _pattern_mask(A, S)
    s_rows = np.repeat(np.arange(n), np.diff(S.indptr))
    s_cols = S.indices
    sc_sel = is_c[s_cols]
    SC = _coo(np.ones(int(sc_sel.sum())), s_rows[sc_sel], s_cols[sc_sel], (n, n))
    sf_sel = cf[s_cols] == F_PT
    SF = _coo(np.ones(int(sf_sel.sum())), s_rows[sf_sel], s_cols[sf_sel], (n, n))

    # common-C test per strong F-F edge: (SC @ SC^T)[i, i1] > 0
    CC = (SC @ SC.T).tocsr()
    CC.sort_indices()
    e = SF.tocoo()
    if common_c_gate:
        has_common = _csr_lookup(CC, e.row, e.col) > 0
    else:  # extended classical interpolation (type 14): always extend
        has_common = np.zeros(len(e.row), dtype=bool)
    E_nc = _coo(
        np.ones(int((~has_common).sum())), e.row[~has_common], e.col[~has_common], (n, n)
    )
    if ff1:
        # FF1 (BuildFF1Interp:3781): for each no-common-C F neighbor
        # (in S row-scan order) add its FIRST strong-C point NOT already
        # in the pattern — stateful per row, replicated exactly
        Sp, Sj = S.indptr, S.indices
        Ei = E_nc.tocsr()
        ext_r, ext_c = [], []
        scr = SC.tocsr()
        for i in np.flatnonzero(f_rows):
            fs = Ei.indices[Ei.indptr[i]:Ei.indptr[i + 1]]
            if fs.size == 0:
                continue
            present = set(scr.indices[scr.indptr[i]:scr.indptr[i + 1]].tolist())
            for i1 in fs:
                for k1 in Sj[Sp[i1]:Sp[i1 + 1]]:
                    if is_c[k1] and k1 not in present:
                        present.add(int(k1))
                        ext_r.append(i)
                        ext_c.append(int(k1))
                        break
        ext = _coo(np.ones(len(ext_r)), np.array(ext_r, dtype=np.int64),
                   np.array(ext_c, dtype=np.int64), (n, n)) if ext_r else sp.csr_matrix((n, n))
        pat = (SC + ext).tocsr()
    else:
        pat = (SC + E_nc @ SC).tocsr()
    pat.data = np.ones_like(pat.data)

    # sign-filtered distribution rows (a_{i1,i2} with sgn(a_{i1,i1})*a < 0)
    sgn = np.where(diag < 0, -1.0, 1.0)
    keep = (sgn[rows] * data) < 0
    Aneg = _coo(np.where(keep, data, 0.0), rows, cols, (n, n))

    T = (pat @ Aneg.T).tocsr()
    T.sort_indices()
    e_i, e_k = rows[strong_pairs & (cf[cols] == F_PT)], cols[strong_pairs & (cf[cols] == F_PT)]
    e_a = data[strong_pairs & (cf[cols] == F_PT)]
    sums = _csr_lookup(T, e_i, e_k) if e_i.size else np.zeros(0)
    lump = sums == 0.0
    D = _coo(np.where(lump, 0.0, e_a / np.where(lump, 1.0, sums)), e_i, e_k, (n, n))
    W2 = (D @ Aneg).tocsr().multiply(pat)

    strongC = strong_pairs & is_c[cols]
    Wdirect = _coo(np.where(strongC, data, 0.0), rows, cols, (n, n))
    W = (Wdirect + W2).tocsr()

    strongF = strong_pairs & (cf[cols] == F_PT)
    offdiag = cols != rows
    weak = offdiag & ~strongC & ~strongF & (cf[cols] != -3)
    d = diag.copy()
    np.add.at(d, rows[weak], data[weak])
    lump_add = np.zeros(n)
    np.add.at(lump_add, e_i[lump], e_a[lump])
    d += lump_add

    Wc = W.tocoo()
    keep_f = f_rows[Wc.row] & is_c[Wc.col] & (Wc.data != 0)
    c_idx = np.flatnonzero(is_c)
    dsafe = np.where(d == 0, 1.0, d)
    P = _coo(
        np.concatenate([-Wc.data[keep_f] / dsafe[Wc.row[keep_f]], np.ones(nc)]),
        np.concatenate([Wc.row[keep_f], c_idx]),
        np.concatenate([cmap[Wc.col[keep_f]], cmap[c_idx]]),
        (n, nc),
    )
    P.sort_indices()
    return P


def extended_interp(A, S, cf):
    """Extended classical interpolation (par_lr_interp.c
    hypre_BoomerAMGBuildExtInterp, interp_type 14): the FF distribution
    with unconditional distance-2 extension (no common-C gate)."""
    return ff_interp(A, S, cf, ff1=False, common_c_gate=False)


def jacobi_interp(
    A: sp.csr_matrix,
    P: sp.csr_matrix,
    cf: np.ndarray,
    num_steps: int = 1,
    trunc_threshold: float = 0.01,
) -> sp.csr_matrix:
    """Jacobi interpolation improvement (par_jacobi_interp.c:48,
    post_interp_type steps):
        P_F <- P_F - D_FF^{-1} (A_F @ P)
    followed by relative-threshold truncation (threshold for positive,
    threshold/2 for negative entries) with row-sum-preserving rescale.
    """
    n, nc = P.shape
    f_rows = cf < 0
    diag = A.diagonal()
    dsafe = np.where(diag == 0, 1.0, diag)
    Dinv_F = sp.diags(np.where(f_rows, 1.0 / dsafe, 0.0))
    for _ in range(num_steps):
        upd = Dinv_F @ (A @ P)
        P = (P - upd).tocsr()
        # truncation (hypre_BoomerAMGTruncateInterp): drop entries
        # relative to the row max, sign-asymmetric thresholds
        Pc = P.tocoo()
        rowmax = np.zeros(n)
        np.maximum.at(rowmax, Pc.row, np.abs(Pc.data))
        thr = np.where(Pc.data >= 0, trunc_threshold, 0.5 * trunc_threshold)
        keep = np.abs(Pc.data) >= thr * rowmax[Pc.row]
        row_sum = np.zeros(n)
        np.add.at(row_sum, Pc.row, Pc.data)
        kept_sum = np.zeros(n)
        np.add.at(kept_sum, Pc.row[keep], Pc.data[keep])
        scale = np.where(kept_sum != 0, row_sum / np.where(kept_sum == 0, 1, kept_sum), 1.0)
        P = _coo(Pc.data[keep] * scale[Pc.row[keep]], Pc.row[keep], Pc.col[keep], (n, nc))
    P.sort_indices()
    return P


def air_restriction(
    A: sp.csr_matrix,
    S: sp.csr_matrix,
    cf: np.ndarray,
    filter_threshold: float = 0.0,
    distance: int = 1,
    neumann_degree: int = -1,
) -> sp.csr_matrix:
    """AIR: local approximate ideal restriction
    (par_restr.c hypre_BoomerAMGBuildRestrAIR, restri_type 1;
    distance=2 mirrors par_lr_restr.c hypre_BoomerAMGBuildRestrDist2AIR
    by extending N_i through strong F-F links; neumann_degree >= 0
    replaces the exact local solve with the degree-k Neumann/Jacobi
    series — the NeumannAIR family).

    For each C point i with strong F neighborhood N_i (via S), solve the
    local transposed system  A[N_i, N_i]^T x = -A[i, N_i]^T  and set
    R[c(i), j] = x_j for j in N_i, R[c(i), i] = 1 — the row-local
    Z = -A_CF A_FF^{-1} of ideal restriction.  Optional relative
    filtering drops |r| < threshold * max|row| (filter_thresholdR).
    Pairs with F-relaxation; built for nonsymmetric problems
    (advection), where R != P^T matters.
    """
    n = A.shape[0]
    is_c = cf > 0
    nc = int(is_c.sum())
    f2c = np.cumsum(is_c) - 1
    Ad = A.tocsr()
    Sp, Sj = S.indptr, S.indices

    rows_out, cols_out, vals_out = [], [], []
    c_pts = np.flatnonzero(is_c)
    # group by neighborhood size for batched solves
    neighborhoods = []
    for i in c_pts:
        nb = Sj[Sp[i]:Sp[i + 1]]
        nb = nb[~is_c[nb] & (cf[nb] != -3)]
        if distance >= 2 and len(nb):
            # distance-2: strong F neighbors of the strong F neighbors
            ext = np.concatenate([Sj[Sp[j]:Sp[j + 1]] for j in nb])
            ext = ext[~is_c[ext] & (cf[ext] != -3) & (ext != i)]
            nb = np.unique(np.concatenate([nb, ext]))
        neighborhoods.append(nb)
    sizes = np.array([len(nb) for nb in neighborhoods])
    for sz in np.unique(sizes):
        idx = np.flatnonzero(sizes == sz)
        if sz == 0:
            continue
        batch = len(idx)
        Mats = np.zeros((batch, sz, sz))
        rhs = np.zeros((batch, sz))
        for b, q in enumerate(idx):
            i = c_pts[q]
            nb = neighborhoods[q]
            Mats[b] = Ad[np.ix_(nb, nb)].toarray()
            rhs[b] = -np.asarray(Ad[i, nb].todense()).ravel()
        # solve A_loc^T x = -A[i, N]^T
        if neumann_degree >= 0:
            # degree-k Neumann series via batched Jacobi refinement
            AT = np.transpose(Mats, (0, 2, 1))
            d = np.einsum("bii->bi", AT)
            dinv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1, d))
            X = dinv * rhs
            for _ in range(neumann_degree):
                X = X + dinv * (rhs - np.einsum("bij,bj->bi", AT, X))
        else:
            try:
                X = np.linalg.solve(np.transpose(Mats, (0, 2, 1)),
                                    rhs[:, :, None])[:, :, 0]
            except np.linalg.LinAlgError:
                X = np.stack([
                    np.linalg.lstsq(Mats[b].T, rhs[b], rcond=None)[0]
                    for b in range(batch)
                ])
        for b, q in enumerate(idx):
            i = c_pts[q]
            nb = neighborhoods[q]
            rows_out.append(np.full(sz, f2c[i]))
            cols_out.append(nb)
            vals_out.append(X[b])
    rows_out.append(f2c[c_pts])
    cols_out.append(c_pts)
    vals_out.append(np.ones(nc))
    R = _coo(
        np.concatenate(vals_out), np.concatenate(rows_out),
        np.concatenate(cols_out), (nc, n),
    )
    if filter_threshold > 0 and R.nnz:
        Rc = R.tocoo()
        rowmax = np.zeros(nc)
        np.maximum.at(rowmax, Rc.row, np.abs(Rc.data))
        keep = np.abs(Rc.data) >= filter_threshold * rowmax[Rc.row]
        R = _coo(Rc.data[keep], Rc.row[keep], Rc.col[keep], (nc, n))
    R.sort_indices()
    return R


def interp_vec_modify(P: sp.csr_matrix, cf: np.ndarray, vecs: np.ndarray,
                      variant: int = 2) -> sp.csr_matrix:
    """Interpolation-vector modification (par_sv_interp.c /
    interp_vec_variant, the GM / LN family): adjust P's F rows so the
    given smooth vectors are interpolated exactly, (P V_C)[i] == V[i]
    for every F row i.

    Variant 2: each F row takes the minimum-norm weight correction that
    meets its k constraints (the least-squares best one through a pinv
    where the row has fewer coarse neighbours than constraints; hypre's
    GM grows the coarse space instead).  Variant 1: the correction goes
    to the row's largest-|w| entry alone.  Rows already exact to 1e-14,
    and rows with a degenerate local Gram, stay as they are."""
    V = np.atleast_2d(np.asarray(vecs, dtype=np.float64))
    if V.shape[0] != P.shape[0]:
        V = V.T
    is_c = cf > 0
    Vc = V[is_c]  # coarse-point values, rows aligned with P's columns
    P = P.tocsr().copy()
    P.sort_indices()
    indptr, indices, data = P.indptr, P.indices, P.data
    for i in np.flatnonzero(~is_c):
        s, e = indptr[i], indptr[i + 1]
        if e == s:
            continue
        w = data[s:e]
        B = Vc[indices[s:e]]  # [m, k]
        r = V[i] - w @ B
        if not np.any(np.abs(r) > 1e-14):
            continue
        if variant == 1 and len(w) > 1:
            j = int(np.argmax(np.abs(w)))
            bj = B[j]
            den = bj @ bj
            if den > 1e-28:
                data[s + j] += (r @ bj) / den
            continue
        lam = np.linalg.pinv(B.T @ B, rcond=1e-12) @ r
        data[s:e] = w + B @ lam
    P.eliminate_zeros()
    return P
