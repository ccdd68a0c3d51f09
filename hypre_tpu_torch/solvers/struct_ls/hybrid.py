"""Struct hybrid solver: diagonal-scaled Krylov that switches to a
multigrid preconditioner when convergence is slow (port of
hypre_tpu/solvers/struct_ls/hybrid.py).

Reference: struct_ls/hybrid.c — run DSCG monitoring the convergence
factor against cf_tol (default 0.90); if DSCG is converging too slowly,
switch to PFMG(/SMG)-preconditioned Krylov.  Same pattern as
parcsr_ls/amg_hybrid.c.  The switch is decided on the host between the
two solves.  On a sharded grid (parallel/par_struct.py::shard_solver)
both phases run on the blocks, the PFMG of phase 2 on the same layout.
"""

from __future__ import annotations

import dataclasses

import torch

from ...struct.matrix import StructMatrix, struct_matvec
from ..krylov import PCGOptions, pcg
from ..krylov.common import SolverResult, tmap
from .jacobi import inverse_diagonal
from .pfmg import PFMG, PFMGOptions


@dataclasses.dataclass(frozen=True)
class StructHybridOptions:
    tol: float = 1e-6
    cf_tol: float = 0.90  # hybrid.c convergence-factor threshold
    dscg_max_iter: int = 100
    pcg_max_iter: int = 100
    pfmg: PFMGOptions = PFMGOptions()
    two_norm: bool = True


class StructHybrid:
    def __init__(self, A: StructMatrix,
                 opts: StructHybridOptions = StructHybridOptions(), *,
                 device=None):
        """`device`: where the solves run (None: A's device)."""
        self.A = A if device is None else A.to(device)
        self.opts = opts
        self._dinv = inverse_diagonal(self.A, self.A.device)
        self._pfmg = None  # built lazily on switch
        self.dscg = None  # phase 1's result, once solved

    def _build_pfmg(self) -> PFMG:
        """Phase 2's preconditioner, set up on the switch."""
        return PFMG(self.A, self.opts.pfmg)

    def solve(self, b, x0=None) -> SolverResult:
        o = self.opts
        op = lambda x: struct_matvec(self.A, x)
        # phase 1: diagonal-scaled CG with convergence-factor early exit
        res = pcg(
            op,
            b,
            x0=x0,
            M=lambda r: tmap(torch.mul, self._dinv, r),
            opts=PCGOptions(
                tol=o.tol,
                max_iter=o.dscg_max_iter,
                cf_tol=o.cf_tol,
                two_norm=o.two_norm,
            ),
        )
        self.dscg = res
        if bool(res.converged):
            return res
        # phase 2: PFMG-preconditioned CG continuing from phase-1 iterate
        if self._pfmg is None:
            self._pfmg = self._build_pfmg()
        return pcg(
            op,
            b,
            x0=res.x,
            M=self._pfmg.precond,
            opts=PCGOptions(tol=o.tol, max_iter=o.pcg_max_iter, two_norm=o.two_norm),
        )
