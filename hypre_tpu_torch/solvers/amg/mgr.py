"""MGR — multigrid reduction for multiphysics systems (port of
hypre_tpu/solvers/amg/mgr.py).

Reference: parcsr_ls/par_mgr{,_setup,_solve}.c (8.5 kLoC): the user tags
C (kept) and F (reduced) unknowns per level; each level smooths the F
block, forms a reduced coarse operator (Galerkin with an interpolation
built from the F/C blocks), and the final coarse system goes to
BoomerAMG.

Coverage:
  * interp types (par_mgr.c:3139 hypre_MGRBuildInterp dispatch):
      "injection"   P = [0; I]                  (MGRBuildP method 0)
      "jacobi"      P = [-D_ff^{-1} A_fc; I]    (method 2)
      "blk_jacobi"  P = [-B_ff^{-1} A_fc; I]    (CPR-style: B_ff = dense
                    inverse of the blk_size x blk_size diagonal blocks
                    of A_ff, par_mgr.c:3396 hypre_blockRelax_setup role)
      "approx_inv"  P = [-M_ff A_fc; I], M_ff a sparse approximate
                    inverse by minimal-residual + Newton-Schulz-
                    Hotelling sweeps (par_mgr.c:2696
                    hypre_MGRBuildInterpApproximateInverse ->
                    hypre_MGRApproximateInverse -> par_ilu.c
                    hypre_ILUParCSRInverseNSH)
      "classical"   modified classical interpolation on the C/F split
                    (par_mgr.c:3168 else-branch -> BoomerAMGBuildInterp)
  * restriction types (par_mgr.c:3232 hypre_MGRBuildRestrict):
      "injection" R = [0 I]; "jacobi"/"blk_jacobi" R = [W_r I] with
      W_r = -A_cf D_ff^{-1} / -A_cf B_ff^{-1} (MGRBuildP on A^T)
  * F-relaxation (Frelax_method, par_mgr.c:104):
      "jacobi" point sweeps on A_ff; "blk_jacobi" block sweeps
      (hypre_blockRelax, par_mgr.c:3999); "amg" a BoomerAMG V-cycle on
      A_ff (Frelax_method 1)
  * coarse-grid method: "nongalerkin" A_cc + A_cf W_p (hypre's default
    reduction) or "galerkin" R A P (mgr_coarse_grid_method 0)

The setup is the JAX package's host numpy / scipy, line for line; every
block operator the application reads (A_ff, A_cf, W_p, W_r, B_ff^{-1}) is frozen by
`freeze_auto` in the operator's dtype onto `device`, the F-relaxation
and coarse BoomerAMGs live there too, and an application runs the SpMV
kernels' fused forms.  The F / C split and the closing assembly of x
are index ops: x[f] and x[c] written by `index_copy_` into zeros (the
two index sets are disjoint, so the result does not depend on the
order of the writes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import (freeze_auto, kernel_launches, spmv, spmv_axpy,
                        spmv_jacobi, spmv_resid, sum_launches)
from ...utils.errors import arg_error
from ..krylov.common import SolverResult
from .boomeramg import BoomerAMG, BoomerAMGOptions
from .interp import classical_interp
from .strength import strength_matrix


def block_diag_inv(A: sp.csr_matrix, blk: int) -> sp.csr_matrix:
    """Sparse block-diagonal inverse of A's blk x blk diagonal blocks
    (par_mgr.c:3448 hypre_blockRelax_setup: per-block dense inversion;
    trailing rows that do not fill a block get 1x1 blocks).

    The blocks are read from A's entries directly.  The JAX package
    reads them from a dense copy of A's leading nb*blk square, n^2
    values (91 GiB at 110,592 rows); the blocks, and so the result,
    are the same bit for bit."""
    n = A.shape[0]
    nb = n // blk
    inv_blocks = []
    if nb:
        # stacked dense inversion of the leading nb full blocks
        lead = A[: nb * blk, : nb * blk].tocoo()
        on = lead.row // blk == lead.col // blk
        diag_blocks = np.zeros((nb, blk, blk), dtype=A.dtype)
        np.add.at(diag_blocks, (lead.row[on] // blk, lead.row[on] % blk,
                                lead.col[on] % blk), lead.data[on])
        inv_blocks.append(np.linalg.inv(diag_blocks))
    rows = []
    cols = []
    vals = []
    if nb:
        bi = inv_blocks[0]
        r = (np.arange(nb)[:, None, None] * blk
             + np.arange(blk)[None, :, None])
        c = (np.arange(nb)[:, None, None] * blk
             + np.arange(blk)[None, None, :])
        rows.append(np.broadcast_to(r, bi.shape).ravel())
        cols.append(np.broadcast_to(c, bi.shape).ravel())
        vals.append(bi.ravel())
    for i in range(nb * blk, n):  # left_size 1x1 tail (par_mgr.c:3436)
        d = A[i, i]
        rows.append(np.array([i]))
        cols.append(np.array([i]))
        vals.append(np.array([1.0 / d if d != 0 else 0.0]))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )


def nsh_approx_inverse(
    A: sp.csr_matrix, droptol: float = 1e-2, mr_iters: int = 1,
    nsh_iters: int = 2, max_row_nnz: int = 2,
) -> sp.csr_matrix:
    """Sparse approximate inverse by minimal-residual iteration followed
    by Newton-Schulz-Hotelling sweeps (par_ilu.c
    hypre_ILUParCSRInverseNSH semantics with the par_mgr.c:2395 default
    parameters: mr_max_iter 1, nsh_max_iter 2, droptol 1e-2, row nnz
    cap 2).  Sparsified by droptol + per-row nnz cap after each sweep."""
    n = A.shape[0]
    d = A.diagonal()
    dinv = np.where(d == 0, 0.0, 1.0 / np.where(d == 0, 1.0, d))
    M = sp.diags(dinv).tocsr()

    def sparsify(X):
        X = X.tocsr()
        X.data[np.abs(X.data) < droptol] = 0.0
        X.eliminate_zeros()
        if max_row_nnz and X.nnz:
            nnz_row = np.diff(X.indptr)
            if nnz_row.max() > max_row_nnz:
                keep = np.zeros(X.nnz, dtype=bool)
                for i in np.flatnonzero(nnz_row > 0):
                    lo, hi = X.indptr[i], X.indptr[i + 1]
                    seg = np.abs(X.data[lo:hi])
                    take = np.argsort(-seg, kind="stable")[:max_row_nnz]
                    keep[lo + take] = True
                X.data[~keep] = 0.0
                X.eliminate_zeros()
        return X

    # minimal-residual sweeps: M += alpha * R, R = I - A M, alpha =
    # <R, A R>_F / <A R, A R>_F (global step, mr_col_version 0)
    I = sp.identity(n, format="csr")
    for _ in range(mr_iters):
        R = (I - A @ M).tocsr()
        AR = (A @ R).tocsr()
        denom = (AR.multiply(AR)).sum()
        if denom == 0:
            break
        alpha = (R.multiply(AR)).sum() / denom
        M = sparsify((M + alpha * R).tocsr())
    # Newton-Schulz: M <- M (2I - A M)
    for _ in range(nsh_iters):
        M = sparsify((M @ (2.0 * I - A @ M)).tocsr())
    return M


@dataclasses.dataclass(frozen=True)
class MGROptions:
    interp_type: str = "jacobi"
    restrict_type: str = "injection"
    frelax: str = "jacobi"  # jacobi | blk_jacobi | amg  (Frelax_method)
    num_f_sweeps: int = 1
    blk_size: int = 1
    coarse_grid_method: str = "nongalerkin"  # nongalerkin | galerkin
    amg: BoomerAMGOptions = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18,
    )
    # F-relax AMG options (Frelax_method 1); embed disabled: A_ff is a
    # submatrix with no lattice structure
    famg: BoomerAMGOptions = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False, max_levels=10,
    )


class MGR:
    def __init__(self, A: CSRMatrix, c_masks, opts: MGROptions = MGROptions(),
                 *, device="cuda"):
        """c_masks: boolean array (single level) or list of boolean
        arrays, one per reduction level (true = kept/C point)."""
        self.opts = opts
        self.device = dev = torch.device(device)
        if isinstance(c_masks, np.ndarray):
            c_masks = [c_masks]
        self.levels = []
        self.host_Ac = []  # each level's coarse operator (host), for inspection
        As = A.to_scipy().tocsr()
        dt = torch_dtype(As.dtype.name)

        def frz(M):
            return freeze_auto(CSRMatrix.from_scipy(M), dt, dev)

        for cm in c_masks:
            cm = np.asarray(cm, dtype=bool)
            cidx = np.flatnonzero(cm)
            fidx = np.flatnonzero(~cm)
            Aff = As[fidx][:, fidx].tocsr()
            Afc = As[fidx][:, cidx].tocsr()
            Acf = As[cidx][:, fidx].tocsr()
            Acc = As[cidx][:, cidx].tocsr()
            dff = Aff.diagonal()
            dffi = np.where(dff == 0, 0.0, 1.0 / np.where(dff == 0, 1, dff))
            Bffi = None
            if (opts.blk_size > 1
                    and ("blk" in opts.interp_type
                         or "blk" in opts.restrict_type
                         or opts.frelax == "blk_jacobi")):
                Bffi = block_diag_inv(Aff, opts.blk_size)
            Wp = self._build_w(opts.interp_type, Aff, Afc, dffi, Bffi)
            Wr = None
            if opts.restrict_type != "injection":
                # MGRBuildP on A^T (par_mgr.c:3236): W_r^T from the
                # transposed blocks -> W_r = -A_cf D_ff^{-1}
                Wr = self._build_w(
                    opts.restrict_type, Aff.T.tocsr(), Acf.T.tocsr(),
                    dffi, Bffi.T.tocsr() if Bffi is not None else None,
                ).T.tocsr()
            if opts.coarse_grid_method == "galerkin":
                nf, nc = Afc.shape
                Pfull = sp.vstack(
                    [Wp, sp.identity(nc, format="csr")], format="csr")
                Rfull = sp.hstack(
                    [Wr if Wr is not None else sp.csr_matrix((nc, nf)),
                     sp.identity(nc, format="csr")], format="csr")
                # order rows/cols back to [F; C] for the product
                perm = np.concatenate([fidx, cidx])
                Ablk = As[perm][:, perm].tocsr()
                Ac = (Rfull @ Ablk @ Pfull).tocsr()
            else:
                Ac = (Acc + Acf @ Wp).tocsr()
            famg = None
            if opts.frelax == "amg":
                famg = BoomerAMG(CSRMatrix.from_scipy(Aff), opts.famg,
                                 device=dev)
            self.levels.append(
                dict(
                    cidx=torch.from_numpy(cidx).to(dev),
                    fidx=torch.from_numpy(fidx).to(dev),
                    n=As.shape[0],
                    Aff=frz(Aff),
                    Acf=frz(Acf),
                    Wp=frz(Wp),
                    Wr=frz(Wr) if Wr is not None else None,
                    dffi=to_device(dffi, dt, dev),
                    Bffi=frz(Bffi) if Bffi is not None else None,
                    famg=famg,
                )
            )
            self.host_Ac.append(Ac)
            As = Ac
        self.amg = BoomerAMG(CSRMatrix.from_scipy(As), opts.amg, device=dev)

    @staticmethod
    def _build_w(kind, Aff, Afc, dffi, Bffi):
        if kind == "injection":
            return sp.csr_matrix(Afc.shape)
        if kind == "jacobi":
            return (-sp.diags(dffi) @ Afc).tocsr()
        if kind == "blk_jacobi":
            if Bffi is None:
                raise arg_error("blk_jacobi needs blk_size > 1")
            return (-Bffi @ Afc).tocsr()
        if kind == "approx_inv":
            return (-nsh_approx_inverse(Aff) @ Afc).tocsr()
        if kind == "classical":
            nf, nc = Afc.shape
            # modified classical interp on the [F; C] block ordering
            Ablk = sp.bmat(
                [[Aff, Afc],
                 [sp.csr_matrix((nc, nf)), sp.identity(nc, format="csr")]],
                format="csr",
            )
            cf = np.concatenate(
                [-np.ones(nf, dtype=np.int64), np.ones(nc, dtype=np.int64)]
            )
            S = strength_matrix(Ablk, 0.25, 0.9)
            P = classical_interp(Ablk, S, cf).tocsr()
            return P[:nf].tocsr()
        raise arg_error(f"unknown MGR interp/restrict type {kind!r}")

    # ------------------------------------------------------------------
    def _frelax(self, lv, rf):
        o = self.opts
        if lv["famg"] is not None:
            return lv["famg"].cycle(rf)
        if o.frelax == "blk_jacobi" and lv["Bffi"] is not None:
            xf = spmv(lv["Bffi"], rf)
            for _ in range(o.num_f_sweeps - 1):
                xf = spmv_axpy(lv["Bffi"], spmv_resid(lv["Aff"], xf, rf), xf)
            return xf
        xf = lv["dffi"] * rf
        for _ in range(o.num_f_sweeps - 1):
            xf = spmv_jacobi(lv["Aff"], lv["dffi"], xf, rf, 1.0)
        return xf

    def _apply(self, l, r):
        """One MGR level: F-relax, restrict, recurse, interpolate."""
        lv = self.levels[l]
        rf = r[lv["fidx"]]
        rc = r[lv["cidx"]]
        xf = self._frelax(lv, rf)
        # restricted residual R r' with r' = r - A [xf; 0]
        rc_red = spmv_resid(lv["Acf"], xf, rc)
        if lv["Wr"] is not None:
            rc_red = spmv_axpy(lv["Wr"], spmv_resid(lv["Aff"], xf, rf),
                               rc_red)
        if l + 1 < len(self.levels):
            xc = self._apply(l + 1, rc_red)
        else:
            xc = self.amg.cycle(rc_red)
        # interpolate: xf += Wp xc
        xf = spmv_axpy(lv["Wp"], xc, xf)
        x = r.new_zeros(lv["n"])
        x.index_copy_(0, lv["fidx"], xf)
        x.index_copy_(0, lv["cidx"], xc)
        return x

    def precond(self, r):
        return self._apply(0, r)

    def apply_launches(self) -> dict:
        """{kernel name: launches} of one `precond` application: each
        level's F-relaxation (its BoomerAMG's `cycle_launches`, or its
        matvecs), A_cf, W_r with its A_ff residual, W_p, and the coarse
        BoomerAMG's cycle."""
        extra = self.opts.num_f_sweeps - 1
        parts = []
        for lv in self.levels:
            Aff = kernel_launches(lv["Aff"])
            if lv["famg"] is not None:
                parts.append((lv["famg"].cycle_launches(), 1))
            elif self.opts.frelax == "blk_jacobi" and lv["Bffi"] is not None:
                parts += [(kernel_launches(lv["Bffi"]), 1 + extra),
                          (Aff, extra)]
            else:
                parts.append((Aff, extra))
            parts.append((kernel_launches(lv["Acf"]), 1))
            if lv["Wr"] is not None:
                parts += [(Aff, 1), (kernel_launches(lv["Wr"]), 1)]
            parts.append((kernel_launches(lv["Wp"]), 1))
        parts.append((self.amg.cycle_launches(), 1))
        return sum_launches(parts)

    def solve(self, A: CSRMatrix, b, tol=1e-8, max_iter=100) -> SolverResult:
        """MGR-preconditioned FlexGMRES (k_dim 10) on A, frozen on this
        instance's device."""
        from ..krylov import FlexGMRESOptions, flexgmres

        E = freeze_auto(A, torch_dtype(A.data.dtype.name), self.device)
        return flexgmres(
            lambda x: spmv(E, x), b, M=self.precond,
            opts=FlexGMRESOptions(tol=tol, max_iter=max_iter, k_dim=10),
        )
