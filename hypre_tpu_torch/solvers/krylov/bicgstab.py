"""BiCGSTAB (port of hypre_tpu/solvers/krylov/bicgstab.py).

Reference: krylov/bicgstab.c:233-540 — right-preconditioned (the
preconditioner, then the matvec, :424-425, :439-440), convergence on
||r||_2 <= max(a_tol, tol ||b||_2) with a true-residual check before
convergence is declared (:467-476), gamma 0/0 -> 0 (:443-447), the
cf_tol convergence-factor exit (:489-498).

Two matvecs, two preconditioner applications and five dot products an
iteration.  The scalars stay 0-d tensors on the vectors' device; the
host reads whether the iterate is tentatively converged (the true
residual's extra matvec runs only then) and whether the solve is done.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .common import (SolverResult, Vec, identity_precond, taxpy, tdot,
                     tfirst, tnorm2, tsub, tzeros_like)

_EPSMAC = 1e-128  # bicgstab.c epsmac


@dataclasses.dataclass(frozen=True)
class BiCGSTABOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    min_iter: int = 0
    cf_tol: float = 0.0


def _nz(t: torch.Tensor) -> torch.Tensor:
    """t where it is not 0, else 1 (a safe divisor)."""
    return torch.where(t == 0, 1.0, t)


def bicgstab(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: BiCGSTABOptions = BiCGSTABOptions(),
) -> SolverResult:
    M = M or identity_precond
    x = tzeros_like(b) if x0 is None else x0
    max_iter = int(opts.max_iter)
    b0 = tfirst(b)  # the solve's dtype and device

    r0 = tsub(b, A(x))
    b_norm = tnorm2(b)
    r_norm0 = tnorm2(r0)
    den = torch.where(b_norm > 0, b_norm, r_norm0)
    epsilon = torch.clamp_min(opts.tol * den, opts.a_tol)

    norms = torch.full((max_iter + 1,), float("nan"), dtype=b0.dtype,
                       device=b0.device)
    norms[0] = r_norm0
    res = tdot(r0, r0)  # <r0, r>, first <r0, r0>
    r, p, r_norm = r0, r0, r_norm0
    converged = r_norm0 <= epsilon
    done = bool((r_norm0 == 0.0) | converged)
    cf_ave_1 = torch.zeros((), dtype=b0.dtype, device=b0.device)

    it = 0
    while it < max_iter and not done:
        it += 1
        v = M(p)
        q = A(v)
        temp = tdot(r0, q)
        breakdown1 = temp.abs() < _EPSMAC
        alpha = res / torch.where(breakdown1, 1.0, temp)
        x = taxpy(alpha, v, x)
        r = taxpy(-alpha, q, r)

        v2 = M(r)
        s = A(v2)
        g_num = tdot(r, s)
        g_den = tdot(s, s)
        gamma = torch.where((g_num == 0.0) & (g_den == 0.0), 0.0,
                            g_num / _nz(g_den))
        x = taxpy(gamma, v2, x)
        r = taxpy(-gamma, s, r)

        r_norm = tnorm2(r)
        norms[it] = r_norm

        # the true residual confirms convergence (bicgstab.c:467-476)
        tentative = bool(r_norm <= epsilon) and it >= opts.min_iter
        conv_now = torch.zeros((), dtype=torch.bool, device=b0.device)
        if tentative:
            r = tsub(b, A(x))
            r_norm = tnorm2(r)
            conv_now = r_norm <= epsilon

        stop_cf = torch.zeros((), dtype=torch.bool, device=b0.device)
        if opts.cf_tol > 0.0:
            cf_ave_0 = cf_ave_1
            cf_ave_1 = (r_norm / torch.where(r_norm0 > 0, r_norm0, 1.0)) ** (
                1.0 / (2.0 * it))
            weight = (cf_ave_1 - cf_ave_0).abs() / torch.clamp_min(
                torch.maximum(cf_ave_1, cf_ave_0), _EPSMAC)
            stop_cf = (1.0 - weight) * cf_ave_1 > opts.cf_tol

        # beta = (res_new / res)(alpha / gamma); p = r + beta (p - gamma q)
        breakdown2 = (res.abs() < _EPSMAC) | (gamma.abs() < _EPSMAC)
        res_new = tdot(r0, r)
        beta = (res_new / _nz(res)) * (alpha / _nz(gamma))
        p = taxpy(beta, taxpy(-gamma, q, p), r)
        res = res_new

        converged = converged | conv_now
        done = bool(conv_now | breakdown1 | breakdown2 | stop_cf)

    return SolverResult(
        x=x,
        num_iterations=it,
        rel_residual_norm=r_norm / torch.where(den > 0, den, 1.0),
        converged=bool(converged),
        res_norms=norms,
    )
