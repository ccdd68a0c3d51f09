"""SStruct Split solver — block solves per (part, var) (port of
hypre_tpu/solvers/sstruct_ls/split.py).

Reference: sstruct_ls/HYPRE_sstruct_split.c:150-260 — per iteration:
  y = b - N x   (N = inter-variable S blocks + the whole U matrix)
  x_pv = M_pv^{-1} y_pv  per diagonal block, where M_pv is one
         application of a struct solver (SMG/PFMG/Jacobi) on S_pvpv
Convergence on ||b - A x|| / ||b|| checked at the top of each iteration.

Sub-solver: one SMG (the reference default) or PFMG V-cycle from the
current x, or weighted Jacobi sweeps.  The sub-solvers' setup runs on
the host; their cycles, the matvecs and the U product run on the
device of A's blocks.  `solve` is a Python loop with one host read an
iteration (the residual's squared norm), where the JAX package runs one
`lax.while_loop`; it returns the same fields: the count, the final
relative residual, and the NaN-padded [max_iter + 1] residual history.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...sstruct.matrix import SStructMatrix, sstruct_matvec
from ...sstruct.vector import pack_vector, unpack_vector
from ...ops.dia import spmv
from ...struct.matrix import struct_matvec
from ..krylov.common import SolverResult, tdot, tfirst, tsub, tzeros_like
from ..struct_ls.pfmg import PFMG, PFMGOptions
from ..struct_ls.smg import SMG, SMGOptions


@dataclasses.dataclass(frozen=True)
class SplitOptions:
    tol: float = 1e-6
    max_iter: int = 200
    ssolver: str = "smg"  # smg (reference default) | pfmg | jacobi
    pfmg: PFMGOptions = PFMGOptions(skip_relax=0)
    jacobi_sweeps: int = 2


class SStructSplit:
    def __init__(self, A: SStructMatrix, opts: SplitOptions = SplitOptions()):
        self.A = A
        self.opts = opts
        self._sub = {}
        self._dinv = {}
        g = A.grid
        for p in range(g.nparts):
            for v in range(g.nvars(p)):
                sm = A.diag_block(p, v)
                if opts.ssolver == "pfmg":
                    self._sub[(p, v)] = PFMG(sm, opts.pfmg)
                elif opts.ssolver == "smg":
                    self._sub[(p, v)] = SMG(sm, SMGOptions())
                diag = sm.diagonal().cpu().numpy()
                self._dinv[(p, v)] = torch.from_numpy(
                    np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1, diag))
                ).to(sm.device)

    def _block_solve(self, p, v, rhs, x_cur):
        """Sub-solve S_pv z = rhs starting from the CURRENT x (the
        reference passes sx as initial guess, HYPRE_sstruct_split.c:247 —
        this makes the true solution an exact fixed point even with
        inexact sub-solves)."""
        o = self.opts
        if o.ssolver in ("pfmg", "smg"):
            return self._sub[(p, v)].cycle(rhs, u=x_cur)
        sm = self.A.diag_block(p, v)
        dinv = self._dinv[(p, v)]
        x = x_cur
        for _ in range(o.jacobi_sweeps):
            x = x + dinv * (rhs - struct_matvec(sm, x))
        return x

    def _resid_sq(self, x, b) -> torch.Tensor:
        r = tsub(b, sstruct_matvec(self.A, x))
        return tdot(r, r)

    def solve(self, b, x0=None) -> SolverResult:
        o = self.opts
        x = tzeros_like(b) if x0 is None else x0
        b0 = tfirst(b)
        b_dot_b = float(tdot(b, b))
        den = b_dot_b if b_dot_b > 0 else 1.0
        eps = o.tol**2

        norms = torch.full((o.max_iter + 1,), float("nan"), dtype=b0.dtype,
                           device=b0.device)
        rr_t = self._resid_sq(x, b)
        norms[0] = torch.sqrt(rr_t)
        rr = float(rr_t)
        it = 0
        while it < o.max_iter and rr / den >= eps:
            x = self._step(x, b)
            rr_t = self._resid_sq(x, b)
            it += 1
            norms[it] = torch.sqrt(rr_t)
            rr = float(rr_t)
        rel = float(np.sqrt(rr / den))
        return SolverResult(
            x=x,
            num_iterations=it,
            rel_residual_norm=torch.tensor(rel, dtype=b0.dtype,
                                           device=b0.device),
            converged=rel < o.tol,
            res_norms=norms,
        )

    def _step(self, x, b):
        g = self.A.grid
        # y = b - N x (off-diagonal S blocks + U)
        y = [[b[p][v] for v in range(g.nvars(p))] for p in range(g.nparts)]
        for (p, vi, vj), sm in self.A.smats.items():
            if vi != vj:
                y[p][vi] = y[p][vi] - struct_matvec(sm, x[p][vj])
        if self.A.umat is not None:
            up = unpack_vector(spmv(self.A.umat, pack_vector(x)), g)
            for p in range(g.nparts):
                for v in range(g.nvars(p)):
                    y[p][v] = y[p][v] - up[p][v]
        # x = M^{-1} y blockwise (initial guess = current x)
        return tuple(
            tuple(
                self._block_solve(p, v, y[p][v], x[p][v])
                for v in range(g.nvars(p))
            )
            for p in range(g.nparts)
        )
