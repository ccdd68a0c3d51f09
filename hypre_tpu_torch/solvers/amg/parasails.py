"""ParaSails — sparse approximate inverse preconditioner (port of
hypre_tpu/solvers/amg/parasails.py).

Reference: distributed_ls/ParaSails/ (~8 kLoC): pattern from powers of a
thresholded matrix, least-squares rows; factored (FSAI) form for SPD
problems, unfactored for general.

The setup is the JAX package's host numpy (the per-row least-squares /
Cholesky solves batched by pattern size); the apply is one (or two,
factored) sparse matvecs through the frozen formats of ops/dia.py —
on the card K1 (DIA) or the ELL kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, spmv


@dataclasses.dataclass(frozen=True)
class ParaSailsOptions:
    thresh: float = 0.1  # drop |a_ij| < thresh*sqrt(a_ii a_jj)
    nlevels: int = 1  # pattern = (sparsified A)^(nlevels+1) rows
    filter: float = 0.05  # post-filter small M entries
    symmetric: bool = True  # factored FSAI (SPD) vs unfactored


def _fsai(As: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    """Factored sparse approximate inverse: per row i solve
    A[J,J] y = e_i over J = lower-pattern(i), normalize so that
    G A G^T ~ I.

    Vectorized: rows are grouped by pattern size k and each group is
    one batched [m, k, k] dense solve (LAPACK over the leading axis);
    the A[J,J] blocks come from one searchsorted into the CSR's
    (row*n + col) key array — no per-row python work."""
    n = As.shape[0]
    As = As.tocsr()
    As.sort_indices()
    Pl = sp.tril(P).tocsr()

    # entry lookup: sorted 64-bit keys row*n + col
    rows64 = np.repeat(np.arange(n, dtype=np.int64), np.diff(As.indptr))
    keys = rows64 * n + As.indices
    data = As.data

    def lookup(q):
        pos = np.searchsorted(keys, q.ravel())
        pos = np.clip(pos, 0, max(len(keys) - 1, 0))
        hit = keys[pos] == q.ravel()
        out = np.where(hit, data[pos], 0.0)
        return out.reshape(q.shape)

    # per-row patterns J (lower triangle incl. diagonal, sorted)
    Jlists = []
    ks = np.zeros(n, dtype=np.int64)
    for i in range(n):
        J = Pl.indices[Pl.indptr[i]: Pl.indptr[i + 1]]
        J = np.sort(J[J <= i])
        if J.size == 0 or J[-1] != i:
            J = np.append(J, i)
        Jlists.append(J)
        ks[i] = len(J)

    rows_l, cols_l, vals_l = [], [], []
    for k in np.unique(ks):
        ridx = np.flatnonzero(ks == k)
        # int64 before the keys: J * n overflows int32 (scipy's index
        # type) from n = 46,341 rows on (the JAX package's copy keeps
        # int32 there and reads wrong entries on larger levels)
        Jmat = np.stack([Jlists[i] for i in ridx]).astype(np.int64)  # [m, k]
        Q = Jmat[:, :, None] * n + Jmat[:, None, :]
        blk = lookup(Q)  # [m, k, k]
        e = np.zeros((len(ridx), k))
        e[:, -1] = 1.0
        try:
            y = np.linalg.solve(blk, e[..., None])[..., 0]
        except np.linalg.LinAlgError:
            y = np.stack([
                np.linalg.lstsq(blk[t], e[t], rcond=None)[0]
                for t in range(len(ridx))
            ])
        bad = ~np.isfinite(y).all(axis=1)
        for t in np.flatnonzero(bad):
            y[t] = np.linalg.lstsq(blk[t], e[t], rcond=None)[0]
        piv = y[:, -1]
        scale = np.where(
            piv != 0, 1.0 / np.sqrt(np.abs(np.where(piv == 0, 1, piv))), 1.0
        )
        rows_l.append(np.repeat(ridx, k))
        cols_l.append(Jmat.ravel())
        vals_l.append((y * scale[:, None]).ravel())
    G = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=As.shape,
    ).tocsr()
    return G


def _spai(As: sp.csr_matrix, P: sp.csr_matrix) -> sp.csr_matrix:
    """Unfactored SPAI: per row minimize ||e_i - m_i A|| over pattern."""
    n = As.shape[0]
    AT = As.T.tocsr()
    rows_l, cols_l, vals_l = [], [], []
    for i in range(n):
        J = P.indices[P.indptr[i] : P.indptr[i + 1]]
        # columns of A touched by rows J
        sub = AT[:, J]  # [n, k] sparse — restrict to nonzero rows
        I = np.unique(sub.tocoo().row)
        B = np.asarray(As[np.ix_(J, I)].todense())  # [k, |I|]
        e = np.zeros(len(I))
        e[np.searchsorted(I, i)] = 1.0
        m = np.linalg.lstsq(B.T, e, rcond=None)[0]
        rows_l.append(np.full(len(J), i))
        cols_l.append(J)
        vals_l.append(m)
    return sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=As.shape,
    ).tocsr()


def parasails_factors(A: CSRMatrix, opts: ParaSailsOptions = ParaSailsOptions()):
    """The host factors: (G, None) in the symmetric (FSAI) form, (None, M)
    otherwise, as scipy CSR."""
    As = A.to_scipy().tocsr()
    n = As.shape[0]

    # sparsified pattern matrix (Matrix.c threshold rule)
    d = np.sqrt(np.abs(As.diagonal()))
    d[d == 0] = 1.0
    Ac = As.tocoo()
    keep = np.abs(Ac.data) >= opts.thresh * d[Ac.row] * d[Ac.col]
    S = sp.coo_matrix(
        (np.ones(int(keep.sum())), (Ac.row[keep], Ac.col[keep])), shape=As.shape
    ).tocsr()
    P = S.copy()
    for _ in range(opts.nlevels):
        P = ((P @ S) > 0).astype(np.float64).tocsr()
    P = (P + sp.eye(n, format="csr")).tocsr()
    if opts.symmetric:
        return _fsai(As, P), None
    return None, _spai(As, P)


@dataclasses.dataclass(frozen=True)
class ParaSailsData:
    """The sparse-approximate-inverse apply — the BoomerAMG smooth_type 8
    level smoother (par_cycle.c: levels below smooth_num_levels call
    HYPRE_ParaSailsSolve instead of relaxation).  Factored (G^T G) when
    symmetric, else M; each a frozen operator."""

    G: Optional[object] = None
    GT: Optional[object] = None
    M: Optional[object] = None


def build_parasails_data(A: CSRMatrix,
                         opts: ParaSailsOptions = ParaSailsOptions(), *,
                         device="cuda", dtype="float64") -> ParaSailsData:
    """The factors frozen in `dtype` on `device`."""
    G, M = parasails_factors(A, opts)
    dev = torch.device(device)

    def freeze(X):
        return freeze_auto(CSRMatrix.from_scipy(X), dtype, dev)

    if G is not None:
        return ParaSailsData(G=freeze(G), GT=freeze(G.T.tocsr()))
    return ParaSailsData(M=freeze(M))


class ParaSails:
    def __init__(self, A: CSRMatrix, opts: ParaSailsOptions = ParaSailsOptions(),
                 *, device="cuda", dtype="float64"):
        self.opts = opts
        self.data = build_parasails_data(A, opts, device=device, dtype=dtype)

    def solve(self, r):
        """Apply M^{-1}: factored G^T G r, unfactored M r."""
        return parasails_apply(self.data, r)

    @property
    def precond(self):
        return self.solve


def parasails_apply(pd: ParaSailsData, r):
    if pd.G is not None:
        return spmv(pd.GT, spmv(pd.G, r))
    return spmv(pd.M, r)


def parasails_smooth(pd: ParaSailsData, matvec, u, f, weight=1.0):
    """u += w * M^{-1} (f - A u) — one ParaSails smoothing sweep."""
    return u + weight * parasails_apply(pd, f - matvec(u))
