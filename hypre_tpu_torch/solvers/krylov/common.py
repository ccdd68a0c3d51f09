"""Krylov solver plumbing — the vtable analog (port of
hypre_tpu/solvers/krylov/common.py).

The reference writes each Krylov method once against a function-pointer
vtable {Matvec, InnerProd, Axpy, ...} (krylov/pcg.h:49-70).  Here solvers
take `A` and `M` as callables on torch vectors; the helpers below are
the InnerProd / Axpy slots.
"""

from __future__ import annotations

import dataclasses

import torch

Vec = torch.Tensor


def tdot(x: Vec, y: Vec) -> torch.Tensor:
    """<x, y> (the InnerProd vtable slot), a 0-d tensor on x's device."""
    return torch.dot(x, y)


def taxpy(alpha, x: Vec, y: Vec) -> Vec:
    return y + alpha * x


def tscale(alpha, x: Vec) -> Vec:
    return alpha * x


def tsub(x: Vec, y: Vec) -> Vec:
    return x - y


def tadd(x: Vec, y: Vec) -> Vec:
    return x + y


def tzeros_like(x: Vec) -> Vec:
    return torch.zeros_like(x)


def tnorm2(x: Vec) -> torch.Tensor:
    return torch.sqrt(tdot(x, x))


def identity_precond(r: Vec) -> Vec:
    return r


@dataclasses.dataclass
class SolverResult:
    """What hypre exposes via GetNumIterations / GetFinalRelativeResidualNorm
    / logging>1 residual histories (pcg.h:139-141)."""

    x: Vec
    num_iterations: int
    rel_residual_norm: torch.Tensor  # 0-d, on the solve's device
    converged: bool
    res_norms: torch.Tensor  # [max_iter + 1] per-iteration ||r||, NaN beyond
