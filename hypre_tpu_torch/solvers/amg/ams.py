"""AMS — auxiliary-space Maxwell solver for edge elements (port of
hypre_tpu/solvers/amg/ams.py).

Reference: parcsr_ls/ams.c (hypre_AMSSetup/Solve, ~3980 LoC).  The
preconditioner for A = curl-curl + mass on Nedelec edges combines:
  * a smoother on A (reference default l1-GS; here l1-Jacobi)
  * a nodal correction through the discrete gradient:  G B_G G^T,
    B_G = AMG on A_G = G^T A G           (ams.c "G-space")
  * a vector-nodal correction through the Nedelec interpolation
    Pi = [Pi_x Pi_y Pi_z], Pi_d[e, n] = 0.5 |G[e,n]| t_d(e) with t the
    edge tangent from vertex coordinates (hypre_AMSComputePi):
    Pi B_Pi Pi^T, B_Pi = AMG on A_Pi = Pi^T A Pi
  * multiplicative cycle "01210" (ams.c cycle_type 1 default):
    smooth, G-correct, Pi-correct, G-correct, smooth.

The setup (the auxiliary operators, the beta-is-zero test, Pi) is the
JAX package's host numpy / scipy, line for line, so both packages build
the same auxiliary BoomerAMG hierarchies.  A, G, G^T, Pi and Pi^T are
frozen by `freeze_auto` in A's dtype onto `device`; each smoothing sweep
is one `spmv_jacobi` with the l1 inverse, each correction a residual
(`spmv_resid`), a restriction, the auxiliary V-cycle and a prolongation
added in place (`spmv_axpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import (freeze_auto, kernel_launches, spmv, spmv_axpy,
                        spmv_jacobi, spmv_resid, sum_launches)
from ..krylov.common import SolverResult
from .boomeramg import BoomerAMG, BoomerAMGOptions


@dataclasses.dataclass(frozen=True)
class AMSOptions:
    cycle_type: int = 1  # 1 = multiplicative 01210
    amg: BoomerAMGOptions = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18,
    )
    smooth_sweeps: int = 1


def compute_pi(G: CSRMatrix, coords: np.ndarray) -> sp.csr_matrix:
    """Nedelec interpolation Pi: edges x 3*nodes (hypre_AMSComputePi)."""
    Gs = G.to_scipy().tocoo()
    ne, nn = Gs.shape
    # edge tangents from the gradient pattern: t = x_head - x_tail
    tang = np.zeros((ne, 3))
    for d in range(3):
        tang[:, d] = np.asarray(G.to_scipy() @ coords[:, d])
    rows, cols, vals = [], [], []
    for d in range(3):
        rows.append(Gs.row)
        cols.append(Gs.col * 3 + d)  # interleaved nodal ordering (hypre)
        vals.append(0.5 * np.abs(Gs.data) * tang[Gs.row, d])
    Pi = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(ne, 3 * nn),
    ).tocsr()
    Pi.sort_indices()
    return Pi


def _fix_zero_diagonal(M: sp.csr_matrix) -> sp.csr_matrix:
    """M with 1 added on each zero diagonal entry (an isolated auxiliary
    unknown)."""
    fix = np.flatnonzero(M.diagonal() == 0)
    if fix.size:
        M = M + sp.coo_matrix(
            (np.ones(fix.size), (fix, fix)), shape=M.shape
        ).tocsr()
    return M


class AMS:
    """Host setup; A, the transfers, the l1 inverse and the auxiliary
    BoomerAMGs live on `device`."""

    def __init__(
        self,
        A: CSRMatrix,
        G: CSRMatrix,
        coords: np.ndarray,
        opts: AMSOptions = AMSOptions(),
        *,
        device="cuda",
    ):
        self.opts = opts
        self.device = dev = torch.device(device)
        As = A.to_scipy()
        Gs = G.to_scipy()
        dt = torch_dtype(As.dtype.name)
        self._E = freeze_auto(A, dt, dev)

        l1 = np.asarray(np.abs(As).sum(axis=1)).ravel()
        self._l1inv = to_device(
            np.where(l1 == 0, 0.0, 1.0 / np.where(l1 == 0, 1, l1)), dt, dev)

        # G-space: A_G = G^T A G; for a pure curl-curl operator this is
        # exactly zero (beta_is_zero mode, ams.c) -> skip the G-correction
        AG = (Gs.T @ As @ Gs).tocsr()
        AG.sort_indices()
        scale = abs(As).max() or 1.0
        self._beta_is_zero = AG.nnz == 0 or abs(AG).max() < 1e-12 * scale
        self._G = freeze_auto(G, dt, dev)
        self._GT = freeze_auto(CSRMatrix.from_scipy(Gs.T.tocsr()), dt, dev)
        if not self._beta_is_zero:
            AG = _fix_zero_diagonal(AG)
            self._amg_G = BoomerAMG(CSRMatrix.from_scipy(AG), opts.amg,
                                    device=dev)
        else:
            self._amg_G = None

        # Pi-space: A_Pi = Pi^T A Pi
        Pi = compute_pi(G, coords)
        APi = (Pi.T @ As @ Pi).tocsr()
        APi.sort_indices()
        APi = _fix_zero_diagonal(APi)
        self._Pi = freeze_auto(CSRMatrix.from_scipy(Pi), dt, dev)
        self._PiT = freeze_auto(CSRMatrix.from_scipy(Pi.T.tocsr()), dt, dev)
        self._amg_Pi = BoomerAMG(CSRMatrix.from_scipy(APi), opts.amg,
                                 device=dev)

    # ------------------------------------------------------------------
    def _smooth(self, u, b):
        for _ in range(self.opts.smooth_sweeps):
            u = spmv_jacobi(self._E, self._l1inv, u, b, 1.0)
        return u

    def _correct(self, u, b, P, PT, amg):
        """u + P B (P^T (b - A u)): one auxiliary-space correction."""
        return spmv_axpy(P, amg.cycle(spmv(PT, spmv_resid(self._E, u, b))), u)

    def precond(self, b):
        """One multiplicative 01210 cycle, zero initial guess."""
        u = torch.zeros_like(b)
        u = self._smooth(u, b)  # 0
        if self._amg_G is not None:
            u = self._correct(u, b, self._G, self._GT, self._amg_G)  # 1
        u = self._correct(u, b, self._Pi, self._PiT, self._amg_Pi)  # 2
        if self._amg_G is not None:
            u = self._correct(u, b, self._G, self._GT, self._amg_G)  # 1
        u = self._smooth(u, b)  # 0
        return u

    def apply_launches(self) -> dict:
        """{kernel name: launches} of one `precond` application
        (ops/dia.py::kernel_launches of each matvec, the auxiliary
        BoomerAMGs' `cycle_launches`)."""
        spaces = [(self._Pi, self._PiT, self._amg_Pi)]
        if self._amg_G is not None:
            spaces += 2 * [(self._G, self._GT, self._amg_G)]
        parts = [(kernel_launches(self._E), 2 * self.opts.smooth_sweeps)]
        for P, PT, amg in spaces:
            parts += [(kernel_launches(self._E), 1), (kernel_launches(PT), 1),
                      (amg.cycle_launches(), 1), (kernel_launches(P), 1)]
        return sum_launches(parts)

    def solve(self, b, tol=1e-6, max_iter=200) -> SolverResult:
        """AMS-PCG (the ams_driver.c usage pattern)."""
        from ..krylov import PCGOptions, pcg

        return pcg(
            lambda x: spmv(self._E, x),
            b,
            M=self.precond,
            opts=PCGOptions(tol=tol, max_iter=max_iter),
        )
