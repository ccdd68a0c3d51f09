"""Preconditioned conjugate gradients (port of
hypre_tpu/solvers/krylov/pcg.py).

Reference: krylov/pcg.c (solve loop :498-727).  Semantics reproduced:
  * energy-norm (<C r, r>) convergence test by default, two-norm option
  * eps = max(r_tol^2, a_tol^2 / <C b, b>)   (pcg.c:407)
  * zero-rhs short circuit (x = 0, 0 iterations, pcg.c:411-425)
  * rel_change test alpha^2 <p,p>/<x,x> < eps  (pcg.c:668-675)
  * recompute_residual / recompute_residual_p  (pcg.c:535-548, 641-664)
  * rtol residual-change test ||r_new - r_old|| < rtol ||b|| (pcg.c:551-585)
  * cf_tol convergence-factor early exit       (pcg.c:700-727)
  * subnormal alpha/gamma divergence guards    (pcg.c:522-528, 683-689)

The loop runs in Python with the scalars as 0-d tensors on the
vectors' device; the stop test reads one flag to the host per
iteration.  The residual history lands in a NaN-padded
[max_iter + 1] tensor, the JAX package's layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .common import (
    SolverResult,
    Vec,
    identity_precond,
    taxpy,
    tdot,
    tfirst,
    tsub,
    twhere,
    tzeros_like,
)

_TINY = 2.2e-308  # HYPRE_REAL_MIN guard


@dataclasses.dataclass(frozen=True)
class PCGOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    two_norm: bool = False
    rel_change: bool = False
    recompute_residual: bool = False
    recompute_residual_p: int = 0
    rtol: float = 0.0  # residual-change stopping
    cf_tol: float = 0.0


def _nz(t: torch.Tensor) -> torch.Tensor:
    """t where t > 0, else 1 (a safe divisor)."""
    return torch.where(t > 0, t, 1.0)


def pcg(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: PCGOptions = PCGOptions(),
) -> SolverResult:
    M = M or identity_precond
    x = tzeros_like(b) if x0 is None else x0
    max_iter = int(opts.max_iter)
    b0 = tfirst(b)  # the solve's dtype and device

    # <C b, b> (or <b,b>): the normalization (pcg.c:358-366)
    Cb = M(b) if not opts.two_norm else b
    bi_prod = tdot(Cb, b)
    eps = torch.clamp_min(opts.a_tol**2 / _nz(bi_prod), opts.tol**2)

    r = tsub(b, A(x))
    p = M(r)
    gamma = tdot(r, p)
    i_prod_0 = tdot(r, r) if opts.two_norm else gamma
    i_prod = i_prod_0

    norms = torch.full((max_iter + 1,), float("nan"), dtype=b0.dtype,
                       device=b0.device)
    norms[0] = torch.sqrt(i_prod_0)

    zero_rhs = ~(bi_prod > 0.0)
    done = zero_rhs
    converged = zero_rhs  # 0-rhs counts as converged at 0 iterations
    cf_ave_1 = torch.zeros((), dtype=b0.dtype, device=b0.device)

    i = 0
    while i < max_iter and not bool(done):
        i += 1

        s = A(p)
        sdotp = tdot(s, p)
        alpha = gamma / torch.where(sdotp == 0.0, 1.0, sdotp)
        bad = (sdotp == 0.0) | ~(alpha > _TINY)

        gamma_old = gamma
        x = taxpy(alpha, p, x)

        if opts.recompute_residual_p > 0 and i % opts.recompute_residual_p == 0:
            r = tsub(b, A(x))
        else:
            r = taxpy(-alpha, s, r)

        # rtol residual-change test (two-norm form uses alpha^2 <s,s>)
        drob2 = (
            alpha * alpha * tdot(s, s) / bi_prod
            if (opts.rtol > 0 and opts.two_norm)
            else None
        )

        z = M(r)
        gamma = tdot(r, z)
        i_prod = tdot(r, r) if opts.two_norm else gamma

        norms[i] = torch.sqrt(i_prod)

        tentatively = i_prod / _nz(bi_prod) < eps
        if opts.recompute_residual:
            r_true = tsub(b, A(x))
            ip_true = (
                tdot(r_true, r_true) if opts.two_norm else tdot(r_true, M(r_true))
            )
            # only trust the recomputed residual when tentatively converged
            i_prod = torch.where(tentatively, ip_true, i_prod)
            r = twhere(tentatively, r_true, r)
            tentatively = i_prod / _nz(bi_prod) < eps
        if opts.rel_change:
            pi_prod = tdot(p, p)
            xi_prod = tdot(x, x)
            ratio = alpha * alpha * pi_prod / _nz(xi_prod)
            tentatively = tentatively & (ratio < eps)

        stop_rtol = torch.zeros((), dtype=torch.bool, device=b0.device)
        if opts.rtol > 0:
            if opts.two_norm:
                stop_rtol = drob2 < opts.rtol**2
            else:
                stop_rtol = (gamma + gamma_old) / bi_prod < opts.rtol**2

        # cf_tol early exit (pcg.c:700-727)
        stop_cf = torch.zeros((), dtype=torch.bool, device=b0.device)
        if opts.cf_tol > 0.0:
            cf_ave_0 = cf_ave_1
            cf_ave_1 = (i_prod / i_prod_0) ** (1.0 / (2.0 * i))
            weight = torch.abs(cf_ave_1 - cf_ave_0) / torch.clamp_min(
                torch.maximum(cf_ave_1, cf_ave_0), _TINY
            )
            stop_cf = (1.0 - weight) * cf_ave_1 > opts.cf_tol

        diverged = ~(gamma > _TINY) & ~tentatively
        converged = converged | (tentatively & ~bad)
        done = done | tentatively | bad | diverged | stop_rtol | stop_cf

        beta = gamma / torch.where(gamma_old == 0.0, 1.0, gamma_old)
        p = taxpy(beta, p, z)  # p = z + beta p

    # zero-rhs: hypre copies b (= 0) into x (pcg.c:411-425)
    x = twhere(zero_rhs, b, x)

    rel = torch.where(bi_prod > 0, torch.sqrt(i_prod / _nz(bi_prod)), 0.0)
    return SolverResult(
        x=x,
        num_iterations=i,
        rel_residual_norm=rel,
        converged=bool(converged),
        res_norms=norms,
    )
