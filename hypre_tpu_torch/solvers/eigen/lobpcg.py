"""LOBPCG, locally optimal block preconditioned conjugate gradients
(port of hypre_tpu/solvers/eigen/lobpcg.py).

Reference: krylov/lobpcg.c with the multivector vtable of multivector/
(interpreter.h:51) and the dense sub-eigenproblems of the bundled
LAPACK (dsyev / dsygv, fortran_matrix.c).

A multivector is an [n, m] tensor on the solve's device; the vtable's
block operations are matrix products there.  The dense problems (the
m x m Cholesky and its inverse, the 3m x 3m whitening and Rayleigh-Ritz
eigenproblems) are solved on the host by torch's LAPACK: on the H100
(96^3, m 4), cuSOLVER's eigh lost the small pairs of the whitened
matrix, which holds 1e30 for every dropped direction, and LOBPCG
stalled; a cuBLAS triangular solve with the n rows as right-hand sides
took 10 s.  The outer loop reads the convergence test once an
iteration.

A Gram matrix that is not positive definite makes the B-orthonormalized
block NaN, as the JAX package's Cholesky does (torch's `cholesky_ex`
reports the failure instead of raising), and an eigenproblem with a
non-finite entry gives NaN pairs, as jnp.linalg.eigh does (torch's eigh
raises there); the iteration then runs on to max_iter and ends
unconverged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class LOBPCGOptions:
    tol: float = 1e-6
    max_iter: int = 100


@dataclasses.dataclass
class LOBPCGResult:
    eigenvalues: torch.Tensor  # [m]
    eigenvectors: torch.Tensor  # [n, m]
    num_iterations: int
    residual_norms: torch.Tensor  # [m]
    converged: bool


def _cholesky(G: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of the small Gram matrix G, on the host;
    where G is not positive definite, NaN on and below the diagonal
    (jnp.linalg.cholesky's result)."""
    L, info = torch.linalg.cholesky_ex(G.cpu())
    return torch.where(info == 0, L, torch.full_like(L, float("nan")).tril())


def _eigh(M: torch.Tensor):
    """torch.linalg.eigh of a small symmetric matrix, computed on the
    host, or NaN pairs where M has a non-finite entry (jnp.linalg.eigh's
    result)."""
    Mh = M.cpu()
    if bool(torch.isfinite(Mh).all()):
        w, V = torch.linalg.eigh(Mh)
    else:
        V = torch.full_like(Mh, float("nan"))
        w = V[0]
    return w.to(M.device), V.to(M.device)


def _b_orthonormalize(X: torch.Tensor, B) -> torch.Tensor:
    """X L^-T, L the Cholesky factor of X^T B X.  The m x m inverse is
    formed on the host and applied as one product: a triangular solve
    with the n rows as right-hand sides took 10 s in cuBLAS at 96^3."""
    L = _cholesky(X.T @ B(X))
    Linv = torch.linalg.solve_triangular(
        L, torch.eye(L.shape[0], dtype=L.dtype), upper=False)
    return X @ Linv.T.to(X.device)


def lobpcg(
    A: Callable,
    X0: torch.Tensor,
    B: Optional[Callable] = None,
    T: Optional[Callable] = None,
    opts: LOBPCGOptions = LOBPCGOptions(),
) -> LOBPCGResult:
    """The smallest m eigenpairs of A x = lambda B x.

    A, B and T are callables on [n, m] multivectors (column by column);
    T is the preconditioner, applied to the residual block."""
    B = B or (lambda X: X)
    T = T or (lambda R: R)
    m = X0.shape[1]

    X = _b_orthonormalize(X0, B)
    AX = A(X)
    gram = X.T @ AX
    theta, C = _eigh((gram + gram.T) / 2)
    X = X @ C
    AX = AX @ C
    P = torch.zeros_like(X)
    AP = torch.zeros_like(X)

    resnorms = torch.full((m,), float("inf"), dtype=X.dtype, device=X.device)
    it_done = 0
    converged = False
    for it in range(opts.max_iter):
        R = AX - B(X) * theta[None, :]
        resnorms = torch.linalg.vector_norm(R, dim=0) / torch.clamp_min(
            theta.abs(), 1e-300)
        if bool((resnorms < opts.tol).all()):
            converged = True
            it_done = it
            break
        # soft locking: converged columns add no search direction
        # (lobpcg.c's activeMask)
        active = (resnorms >= opts.tol)[None, :]
        W = torch.where(active, T(R), 0.0)
        AW = A(W)
        X, AX, P, AP, theta = _rr_update(B, X, AX, W, AW, P, AP, m, it == 0)
        it_done = it + 1

    order = torch.argsort(theta)
    return LOBPCGResult(
        eigenvalues=theta[order],
        eigenvectors=X[:, order],
        num_iterations=it_done,
        residual_norms=resnorms[order],
        converged=converged,
    )


def _rr_update(B, X, AX, W, AW, P, AP, m: int, first: bool):
    """Rayleigh-Ritz over span[X, W, (P)] with a rank-truncated
    B-whitening (the dsygv and ill-conditioning guards of lobpcg.c)."""
    # normalized search blocks tame the Gram conditioning
    wn = torch.clamp_min(torch.linalg.vector_norm(W, dim=0, keepdim=True),
                         1e-300)
    W, AW = W / wn, AW / wn
    if not first:
        pn = torch.clamp_min(torch.linalg.vector_norm(P, dim=0, keepdim=True),
                             1e-300)
        P, AP = P / pn, AP / pn
    S = torch.cat([X, W] + ([] if first else [P]), dim=1)
    AS = torch.cat([AX, AW] + ([] if first else [AP]), dim=1)
    gA = S.T @ AS
    gB = S.T @ B(S)
    gA = (gA + gA.T) / 2
    gB = (gB + gB.T) / 2
    # drop near-dependent directions rather than let them poison the
    # projected problem
    w, V = _eigh(gB)
    keep = w > 1e-10 * w.max()
    wsafe = torch.where(keep, w, 1.0)
    Binv_half = V * torch.where(keep, 1.0 / torch.sqrt(wsafe), 0.0)[None, :]
    # the dropped directions are zero rows / columns: push them to a
    # huge value so they never rank among the smallest pairs
    Mr = Binv_half.T @ gA @ Binv_half
    Mr = Mr + torch.diag(torch.where(keep, 0.0, 1.0).to(Mr.dtype) * 1e30)
    theta, Z = _eigh((Mr + Mr.T) / 2)
    C = Binv_half @ Z[:, :m]
    theta = theta[:m]

    Xn = S @ C
    AXn = AS @ C
    # P = the part of the update outside X (classic LOBPCG recombination)
    Cp = C.clone()
    Cp[:m, :] = 0.0
    return Xn, AXn, S @ Cp, AS @ Cp, theta
