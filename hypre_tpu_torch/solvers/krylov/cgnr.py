"""CGNR, conjugate gradients on the normal equations (port of
hypre_tpu/solvers/krylov/cgnr.py).

Reference: krylov/cgnr.c — solves A^T A x = A^T b by CG with the
transpose matvec (the MatvecT vtable slot, the callable AT) and the
preconditioner applied to A^T r; convergence on ||r|| / ||b|| with
r = b - A x.  The scalars stay 0-d tensors on the vectors' device; the
host reads whether the solve is done once an iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .common import (SolverResult, Vec, identity_precond, taxpy, tdot,
                     tfirst, tnorm2, tsub, tzeros_like)


@dataclasses.dataclass(frozen=True)
class CGNROptions:
    tol: float = 1e-6
    max_iter: int = 1000
    min_iter: int = 0


def cgnr(
    A: Callable[[Vec], Vec],
    AT: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: CGNROptions = CGNROptions(),
) -> SolverResult:
    M = M or identity_precond
    x = tzeros_like(b) if x0 is None else x0
    max_iter = int(opts.max_iter)
    b0 = tfirst(b)  # the solve's dtype and device

    b_norm = tnorm2(b)
    r = tsub(b, A(x))
    r_norm = tnorm2(r)
    den = torch.where(b_norm > 0, b_norm, torch.where(r_norm > 0, r_norm, 1.0))

    q = M(AT(r))  # the preconditioned normal residual
    p = q
    gamma = tdot(q, q)

    norms = torch.full((max_iter + 1,), float("nan"), dtype=b0.dtype,
                       device=b0.device)
    norms[0] = r_norm
    converged = r_norm / den < opts.tol
    done = bool(converged)

    i = 0
    while i < max_iter and not done:
        i += 1
        w = A(p)
        ww = tdot(w, w)
        alpha = gamma / torch.where(ww == 0, 1.0, ww)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, w, r)
        q = M(AT(r))
        gamma_new = tdot(q, q)
        beta = gamma_new / torch.where(gamma == 0, 1.0, gamma)
        p = taxpy(beta, p, q)
        r_norm = tnorm2(r)
        norms[i] = r_norm
        conv = (r_norm / den < opts.tol) & (i >= opts.min_iter)
        converged = converged | conv
        done = bool(conv | (gamma_new == 0.0))
        gamma = gamma_new

    return SolverResult(
        x=x,
        num_iterations=i,
        rel_residual_norm=r_norm / den,
        converged=bool(converged),
        res_norms=norms,
    )
