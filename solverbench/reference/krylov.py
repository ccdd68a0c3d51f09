"""Plain PCG and restarted GMRES, as hypre's `krylov/` states them.

* `pcg`, hypre's PCG with the two-norm test (`-solver 1` sets it):
  x0 = 0, r = b, p = M r, and each step alpha = <r, z> / <A p, p>,
  x += alpha p, r -= alpha A p, z = M r, stop once <r, r> / <b, b> <
  tol^2, beta = <r, z>_new / <r, z>_old, p = z + beta p (pcg.c).
* `gmres`, hypre's GMRES(k_dim) with right preconditioning: Arnoldi on
  A M by modified Gram-Schmidt, Givens rotations, a step stops its cycle
  once the rotated residual is at most tol ||b|| or max_iter steps are
  done; each cycle ends with x += M (V y) and the true residual, which
  decides convergence (gmres.c).

Both run in the dtype of b, on its device; the small Hessenberg
problem on the host in that dtype.  A configuration names one as its
`krylov.reference` and passes its `krylov.kwargs`, the options the
program's call gets.  Each returns (x, iterations,
converged, ||b - A x|| / ||b|| as the solver last computed it).
"""

from __future__ import annotations

import numpy as np
import torch


def pcg(A, M, b: torch.Tensor, tol: float, max_iter: int,
        two_norm: bool = True):
    if not two_norm:
        raise ValueError("the reference's PCG stops on the two-norm test")
    x = torch.zeros_like(b)
    r = b.clone()
    bb = torch.dot(b, b)
    if not bool(bb > 0):
        return x, 0, True, 0.0
    p = M(r)
    gamma = torch.dot(r, p)
    rr = torch.dot(r, r)
    it, converged = 0, False
    while it < max_iter:
        it += 1
        s = A(p)
        alpha = gamma / torch.dot(s, p)
        x = x + alpha * p
        r = r - alpha * s
        z = M(r)
        gamma_new = torch.dot(r, z)
        rr = torch.dot(r, r)
        if bool(rr / bb < tol * tol):
            converged = True
            break
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return x, it, converged, float(torch.sqrt(rr / bb))


def gmres(A, M, b: torch.Tensor, tol: float, max_iter: int, k_dim: int):
    host = {torch.float64: np.float64, torch.float32: np.float32}[b.dtype]
    x = torch.zeros_like(b)
    r = b.clone()
    b_norm = float(torch.linalg.vector_norm(b))
    r_norm = b_norm
    if b_norm == 0:
        return x, 0, True, 0.0
    eps = tol * b_norm
    it, converged = 0, r_norm <= eps
    while not converged and it < max_iter:
        V = [r / r_norm]
        H = np.zeros((k_dim + 1, k_dim), dtype=host)
        cs = np.zeros(k_dim, dtype=host)
        sn = np.zeros(k_dim, dtype=host)
        rs = np.zeros(k_dim + 1, dtype=host)
        rs[0] = r_norm
        used = 0
        for i in range(k_dim):
            w = A(M(V[i]))
            h = []
            for j in range(i + 1):
                hij = torch.dot(V[j], w)
                w = w - hij * V[j]
                h.append(hij)
            h.append(torch.linalg.vector_norm(w))
            h = torch.stack(h).cpu().numpy().astype(host)
            V.append(w / float(h[-1]) if h[-1] > 0 else w)
            for j in range(i):
                h[j], h[j + 1] = (cs[j] * h[j] + sn[j] * h[j + 1],
                                  -sn[j] * h[j] + cs[j] * h[j + 1])
            d = np.sqrt(h[i] ** 2 + h[i + 1] ** 2)
            cs[i], sn[i] = (h[i] / d, h[i + 1] / d) if d > 0 else (1.0, 0.0)
            rs[i + 1] = -sn[i] * rs[i]
            rs[i] = cs[i] * rs[i]
            H[: i + 1, i] = h[: i + 1]
            H[i, i] = cs[i] * h[i] + sn[i] * h[i + 1]
            used = i + 1
            if abs(rs[i + 1]) <= eps or it + used >= max_iter:
                break
        y = np.zeros(used, dtype=host)
        for j in range(used - 1, -1, -1):
            y[j] = (rs[j] - H[j, j + 1:used] @ y[j + 1:]) / H[j, j]
        corr = torch.zeros_like(b)
        for j in range(used):
            corr = corr + float(y[j]) * V[j]
        x = x + M(corr)
        r = b - A(x)
        r_norm = float(torch.linalg.vector_norm(r))
        it += used
        converged = r_norm <= eps
        if used == 0:
            break
    return x, it, converged, r_norm / b_norm
