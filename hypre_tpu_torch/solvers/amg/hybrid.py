"""AMG hybrid solver (port of hypre_tpu/solvers/amg/hybrid.py).

Reference: parcsr_ls/amg_hybrid.c — run diagonally-scaled Krylov (PCG /
GMRES / BiCGSTAB by solver_type) monitoring the average convergence
factor against cf_tol (default 0.90, :105); if convergence is too slow,
switch to a BoomerAMG-preconditioned run continuing from the current
iterate.  num_iterations reports DSCG + AMG-phase iterations.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import freeze_auto, spmv
from ..krylov import (BiCGSTABOptions, GMRESOptions, PCGOptions, bicgstab,
                      gmres, pcg)
from ..krylov.common import SolverResult
from .boomeramg import BoomerAMG, BoomerAMGOptions


@dataclasses.dataclass(frozen=True)
class AMGHybridOptions:
    tol: float = 1e-6
    cf_tol: float = 0.90
    dscg_max_iter: int = 1000
    pcg_max_iter: int = 200
    solver_type: int = 1  # 1 PCG, 2 GMRES, 3 BiCGSTAB (amg_hybrid.c)
    k_dim: int = 5
    two_norm: bool = True
    amg: BoomerAMGOptions = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18,
    )


class AMGHybrid:
    """The fine operator and D^{-1} live on `device` in the AMG options'
    dtype; the BoomerAMG hierarchy is set up there on the first switch."""

    def __init__(self, A: CSRMatrix, opts: AMGHybridOptions = AMGHybridOptions(),
                 *, device="cuda"):
        self.A = A
        self.opts = opts
        self.device = torch.device(device)
        dt = torch_dtype(opts.amg.dtype)
        self._E = freeze_auto(A, dt, self.device)
        diag = A.diagonal()
        self._dinv = to_device(
            np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1, diag)), dt,
            self.device)
        self._amg: Optional[BoomerAMG] = None
        # iterations of the two phases of the last solve
        self.phase_iterations: tuple = ()

    def _krylov(self, b, x0, M, max_iter, cf_tol):
        o = self.opts
        op = lambda x: spmv(self._E, x)
        if o.solver_type == 2:
            return gmres(op, b, x0=x0, M=M, opts=GMRESOptions(tol=o.tol, max_iter=max_iter, k_dim=o.k_dim))
        if o.solver_type == 3:
            return bicgstab(op, b, x0=x0, M=M, opts=BiCGSTABOptions(tol=o.tol, max_iter=max_iter, cf_tol=cf_tol))
        return pcg(
            op, b, x0=x0, M=M,
            opts=PCGOptions(tol=o.tol, max_iter=max_iter, cf_tol=cf_tol, two_norm=o.two_norm),
        )

    def solve(self, b, x0=None) -> SolverResult:
        o = self.opts
        res = self._krylov(b, x0, lambda r: self._dinv * r, o.dscg_max_iter, o.cf_tol)
        if bool(res.converged):
            self.phase_iterations = (int(res.num_iterations),)
            return res
        dscg_iters = int(res.num_iterations)
        if self._amg is None:
            self._amg = BoomerAMG(self.A, o.amg, device=self.device)
        res2 = self._krylov(b, res.x, self._amg.precond, o.pcg_max_iter, 0.0)
        self.phase_iterations = (dscg_iters, int(res2.num_iterations))
        return dataclasses.replace(
            res2, num_iterations=res2.num_iterations + dscg_iters
        )
