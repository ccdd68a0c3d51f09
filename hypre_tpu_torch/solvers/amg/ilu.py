"""ILU factorization preconditioners/smoothers (port of
hypre_tpu/solvers/amg/ilu.py).

Reference: parcsr_ls/par_ilu{,_setup,_solve}.c (~16 kLoC): ILU(0)/ILUK/
ILUT factorizations with (block-Jacobi across ranks) triangular solves;
the VE fork's level-scheduled substitution applies to the sweeps.

The factorization happens on the host (numpy and the native C kernels of
csrc/host_kernels.c; a failed build raises, so there is no scipy
fallback); the triangular solves run through the Gauss-Seidel
wavefront schedules of relax.py: L y = r is a forward sweep of L with
divisor ones from y = 0, U x = y a backward sweep of U with its
diagonal.  On the card each is one launch of the gs_sweep kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ... import native
from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, spmv
from ...utils.timing import timed
from ..krylov import GMRESOptions, gmres
from .relax import build_gs_schedule, gauss_seidel


@dataclasses.dataclass(frozen=True)
class ILUOptions:
    type: int = 0  # 0 = ILU(k) (fill_level; k=0 default); 1 = ILUT
    fill_level: int = 0  # ILU(k) level of fill (hypre ilu_lfil)
    droptol: float = 0.01  # ILUT drop tolerance (ilu_droptol default)
    max_row_nnz: int = 20  # ILUT fill cap (ilu_max_row_nnz default)


def ilu0_factor(A: sp.csr_matrix):
    """IKJ-variant ILU(0): L (unit lower) and U with A's sparsity."""
    A = A.tocsr().copy()
    A.sort_indices()
    n = A.shape[0]
    indptr, indices, data = A.indptr, A.indices, A.data.astype(np.float64).copy()
    diag_pos = np.zeros(n, dtype=np.int64)
    for i in range(n):
        row = indices[indptr[i] : indptr[i + 1]]
        dp = np.searchsorted(row, i)
        diag_pos[i] = indptr[i] + dp

    # standard in-place IKJ ILU(0)
    col_pos = {}
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        col_pos.clear()
        for p in range(s, e):
            col_pos[indices[p]] = p
        for p in range(s, e):
            k = indices[p]
            if k >= i:
                break
            dk = data[diag_pos[k]]
            if dk == 0:
                continue
            lik = data[p] / dk
            data[p] = lik
            for q in range(diag_pos[k] + 1, indptr[k + 1]):
                j = indices[q]
                pj = col_pos.get(j)
                if pj is not None:
                    data[pj] -= lik * data[q]

    M = sp.csr_matrix((data, indices.copy(), indptr.copy()), shape=A.shape)
    L = sp.tril(M, k=-1).tocsr() + sp.eye(n, format="csr")
    U = sp.triu(M, k=0).tocsr()
    return L.tocsr(), U.tocsr()


def _factors(out, n: int):
    """(L with its unit diagonal, U) from the native kernels' triples."""
    (lp, li, lx), (up, ui, ux) = out
    L = sp.csr_matrix((lx, li, lp), shape=(n, n)) + sp.eye(n, format="csr")
    U = sp.csr_matrix((ux, ui, up), shape=(n, n))
    L.sort_indices()
    U.sort_indices()
    return L.tocsr(), U.tocsr()


def iluk_factor(A: sp.csr_matrix, fill: int):
    """ILU(k) with level-of-fill via the native row-merge kernel (the
    Euclid ilu_mpi_pilu.c role — no external factorization library)."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    return _factors(native.iluk_factor(A.indptr, A.indices, A.data, n, fill),
                    n)


def ilut_factor(A: sp.csr_matrix, droptol=0.01, max_row_nnz=20):
    """Dual-threshold ILUT (Saad) via the native row-merge kernel
    (par_ilu_setup.c hypre_ILUSetupILUT role); (L, U)."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    return _factors(native.ilut_factor(A.indptr, A.indices, A.data, n,
                                       droptol, max_row_nnz), n)


def triangular_pair(L: sp.csr_matrix, U: sp.csr_matrix, device):
    """(forward schedule of L, divisor ones; backward schedule of U,
    divisor its diagonal) on `device`."""
    n = L.shape[0]
    Ls = build_gs_schedule(CSRMatrix.from_scipy(L), forward=True,
                           divisor=np.ones(n), device=device)
    Us = build_gs_schedule(CSRMatrix.from_scipy(U), forward=False,
                           divisor=U.diagonal(), device=device)
    return Ls, Us


def triangular_solve(Lsched, Usched, r):
    """U^{-1} L^{-1} r: two sweeps from zero (two gs_sweep launches on
    the card)."""
    y = gauss_seidel(Lsched, torch.zeros_like(r), r)
    return gauss_seidel(Usched, torch.zeros_like(y), y)


class ILU:
    """M^{-1} r = U^{-1} L^{-1} r via wavefront-scheduled substitution;
    the schedules live on `device`.  The factorization is timed as
    ILU_FACTOR, the schedules' build as ILU_SCHEDULE (GLOBAL_TIMER)."""

    def __init__(self, A: CSRMatrix, opts: ILUOptions = ILUOptions(), *,
                 device="cuda"):
        self.opts = opts
        As = A.to_scipy()
        with timed("ILU_FACTOR"):
            if opts.type == 0:
                if opts.fill_level == 0:
                    L, U = ilu0_factor(As)
                else:
                    L, U = iluk_factor(As, opts.fill_level)
            else:
                L, U = ilut_factor(As, opts.droptol, opts.max_row_nnz)
        self.L, self.U = L, U
        with timed("ILU_SCHEDULE", device=device):
            self._Lsched, self._Usched = triangular_pair(L, U, device)

    def solve(self, r):
        """Apply the preconditioner (the hypre_ILUSolve triangular pair)."""
        return triangular_solve(self._Lsched, self._Usched, r)

    @property
    def precond(self):
        return self.solve


# ---------------------------------------------------------------------------
# Schur-complement ILU (the PILUT / par_ilu GMRES-Schur pipeline role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchurILUOptions:
    num_domains: int = 4
    fill_level: int = 0      # ILU(k) level for the interior blocks
    schur_tol: float = 1e-2  # inner GMRES tolerance on the Schur system
    schur_max_iter: int = 20
    schur_kdim: int = 20


class SchurILU:
    """Two-level Schur-complement ILU preconditioner.

    Reference: distributed_ls/pilut/ (Saad's parallel ILUT: factor each
    domain's INTERIOR independently, reduce the interface unknowns to a
    Schur complement solved iteratively) and parcsr_ls/par_ilu's
    GMRES-in-Schur variants.

    Rows partition into contiguous domains; interior = rows whose
    couplings stay inside their domain, interface = the rest.  With
    A = [[B, F], [E, C]] (interior, interface):
        M^{-1} r solves  B y_B = r_B  (per-domain ILU(k) triangular
        solves), then the Schur system (C - E B^{-1} F) y_S = r_S - E y_B
        by inner GMRES with the exact-action Schur operator (each apply
        = one interior ILU solve), then back-substitutes
        y_B -= B^{-1} F y_S.
    The off-blocks and the interface block are frozen in `dtype` on
    `device`."""

    def __init__(self, A: CSRMatrix, opts: SchurILUOptions = SchurILUOptions(),
                 *, device="cuda", dtype="float64"):
        self.opts = opts
        dev = torch.device(device)
        As = A.to_scipy().tocsr()
        n = As.shape[0]
        D = opts.num_domains
        bounds = np.linspace(0, n, D + 1).astype(np.int64)
        dom = np.searchsorted(bounds[1:], np.arange(n), side="right")
        # interface rows: any coupling crossing a domain boundary
        Ac = As.tocoo()
        cross = dom[Ac.row] != dom[Ac.col]
        iface = np.zeros(n, bool)
        iface[Ac.row[cross]] = True
        iface[Ac.col[cross]] = True
        self.int_idx = np.flatnonzero(~iface)
        self.ifc_idx = np.flatnonzero(iface)
        perm = np.concatenate([self.int_idx, self.ifc_idx])
        self._perm = perm
        self._iperm = np.argsort(perm)
        ni = len(self.int_idx)
        self.ni = ni
        Ap = As[perm][:, perm].tocsr()
        B = Ap[:ni, :ni].tocsr()

        def freeze(M):
            return freeze_auto(CSRMatrix.from_scipy(M.tocsr()), dtype, dev)

        self.F = freeze(Ap[:ni, ni:])
        self.E = freeze(Ap[ni:, :ni])
        self.C = freeze(Ap[ni:, ni:])
        # interior ILU(k): B is block-diagonal by domain, so one global
        # factorization IS the per-domain factorization (no cross fill)
        self._Bilu = ILU(CSRMatrix.from_scipy(B),
                         ILUOptions(type=0, fill_level=opts.fill_level),
                         device=dev)
        # Schur preconditioner: ILU(0) of C
        self._Cilu = ILU(CSRMatrix.from_scipy(Ap[ni:, ni:].tocsr()),
                         ILUOptions(type=0), device=dev)
        self._perm_dev = torch.from_numpy(self._perm).to(dev)
        self._iperm_dev = torch.from_numpy(self._iperm).to(dev)

    def _Binv(self, r):
        return self._Bilu.solve(r)

    def _schur_op(self, y):
        t = self._Binv(spmv(self.F, y))
        return spmv(self.C, y) - spmv(self.E, t)

    def solve(self, r):
        """Apply the two-level preconditioner (host-orchestrated; the
        triangular sweeps and matvecs run on r's device)."""
        o = self.opts
        rp = r[self._perm_dev]
        rB = rp[: self.ni].contiguous()
        rS = rp[self.ni:]
        yB = self._Binv(rB)
        g = rS - spmv(self.E, yB)
        res = gmres(
            self._schur_op, g, M=self._Cilu.solve,
            opts=GMRESOptions(tol=o.schur_tol, max_iter=o.schur_max_iter,
                              k_dim=o.schur_kdim),
        )
        yS = res.x
        yB = yB - self._Binv(spmv(self.F, yS))
        return torch.cat([yB, yS])[self._iperm_dev]

    @property
    def precond(self):
        return self.solve
