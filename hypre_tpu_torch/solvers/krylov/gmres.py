"""Restarted GMRES (port of hypre_tpu/solvers/krylov/gmres.py), and the
restart bookkeeping the GMRES family shares (`_Restarts`,
`_Hessenberg`, `_mgs`, `_scaled`).

Reference: krylov/gmres.c — right-preconditioned (the preconditioner
applied before the matvec, gmres.c:473-474, and once to the accumulated
correction, :663), modified Gram-Schmidt Arnoldi (:477-487), Givens
rotations for the least-squares problem, k_dim default 5 (:80),
convergence on ||r||_2 <= max(a_tol, tol ||b||_2) with the true residual
recomputed at each restart (:677-678); with ||b|| = 0 the first
residual norm is the denominator.

The JAX package runs k_dim masked Arnoldi steps a cycle inside one XLA
program.  Here the steps are a Python loop that stops where that mask
would turn off (the estimate at or below epsilon, or max_iter reached),
so the counts and the history are the JAX package's: the iteration
number is it0 + i_used, norms[it0 + i + 1] holds step i's estimate, and
the restart's true residual overwrites norms[it]; a cycle that takes no
step ends the solve (the stall guard).  The Krylov basis (one stacked
tensor of the vectors' flat views, `common.py::FlatEdge`) and the
products with it stay on the vectors' device; the small Hessenberg
problem (H, the rotations cs / sn, rs) is solved on the host in the
vectors' dtype, from one read of the new column a step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .common import (SolverResult, Vec, flat_problem, taxpy, tdot, tnorm2,
                     tscale, tsub, tzeros_like)

# the host dtype of the Hessenberg problem, the vectors' own
_HOST = {torch.float64: np.float64, torch.float32: np.float32}


@dataclasses.dataclass(frozen=True)
class GMRESOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    k_dim: int = 5


def _mgs(V: torch.Tensor, w: Vec, i: int):
    """w orthogonalized against V[0..i] by modified Gram-Schmidt
    (gmres.c:477-487); returns (w, [h_0j .. h_ij, ||w||] on the host)."""
    hs = []
    for j in range(i + 1):
        hij = tdot(V[j], w)
        w = taxpy(-hij, V[j], w)
        hs.append(hij)
    hs.append(tnorm2(w))
    return w, torch.stack(hs).cpu().numpy()


def _scaled(w: Vec, t, dt) -> Vec:
    """w / t, the reciprocal formed in the vectors' dtype; w unscaled
    where t is 0."""
    return tscale(float(dt(1) / (t if t > 0 else dt(1))), w)


class _Hessenberg:
    """One restart cycle's least-squares problem on the host, in the
    vectors' dtype dt: the rotated Hessenberg columns H [kd + 1, kd],
    the Givens rotations (cs, sn) and the rotated right-hand side rs,
    rs[0] = ||r||."""

    def __init__(self, kd: int, dt, r_norm):
        self.kd, self.dt = kd, dt
        self.H = np.zeros((kd + 1, kd), dtype=dt)
        self.cs = np.zeros(kd, dtype=dt)
        self.sn = np.zeros(kd, dtype=dt)
        self.rs = np.zeros(kd + 1, dtype=dt)
        self.rs[0] = r_norm

    def add_column(self, i: int, h: np.ndarray):
        """Column i (its entries 0..i+1 in h): apply the earlier
        rotations, make rotation i, rotate rs.  Returns the residual
        estimate |rs[i + 1]|."""
        cs, sn, rs = self.cs, self.sn, self.rs
        hc = np.zeros(self.kd + 1, dtype=self.dt)
        hc[:i + 2] = h
        for j in range(i):
            h0 = cs[j] * hc[j] + sn[j] * hc[j + 1]
            h1 = -sn[j] * hc[j] + cs[j] * hc[j + 1]
            hc[j], hc[j + 1] = h0, h1
        denom = np.sqrt(hc[i] ** 2 + hc[i + 1] ** 2)
        denom = denom if denom > 0 else self.dt(1)
        ci, si = hc[i] / denom, hc[i + 1] / denom
        cs[i], sn[i] = ci, si
        rs[i + 1] = -si * rs[i]
        rs[i] = ci * rs[i]
        hc[i] = ci * hc[i] + si * hc[i + 1]
        hc[i + 1] = 0.0
        self.H[:, i] = hc
        return abs(rs[i + 1])

    def solve(self, i_used: int) -> np.ndarray:
        """y of the upper-triangular system H y = rs over the first
        i_used columns (zero beyond)."""
        y = np.zeros(self.kd, dtype=self.dt)
        for j in range(i_used - 1, -1, -1):
            hjj = self.H[j, j] if self.H[j, j] != 0 else self.dt(1)
            y[j] = (self.rs[j] - self.H[j, :] @ y) / hjj
        return y


class _Restarts:
    """The outer loop of the GMRES family: the iterate, its residual
    (norm on the host), epsilon = max(a_tol, tol ||b||) (||r0|| when
    b = 0), the iteration count and the NaN-padded residual history
    [max_iter + 1] on the host, in the vectors' dtype."""

    def __init__(self, A, b: Vec, x0: Optional[Vec], opts):
        self.A, self.b = A, b
        self.max_iter = int(opts.max_iter)
        self.dt = dt = _HOST[b.dtype]
        self.x = tzeros_like(b) if x0 is None else x0
        self.r = tsub(b, A(self.x))
        b_norm, self.r_norm = torch.stack(
            [tnorm2(b), tnorm2(self.r)]).cpu().numpy()
        self.den = b_norm if b_norm > 0 else self.r_norm
        self.eps = max(dt(opts.a_tol), dt(opts.tol) * self.den)
        self.norms = np.full(self.max_iter + 1, np.nan, dtype=dt)
        self.norms[0] = self.r_norm
        self.it = 0
        self.converged = bool(self.r_norm <= self.eps)
        self.done = self.converged or self.r_norm == 0

    def running(self) -> bool:
        return self.it < self.max_iter and not self.done

    def first_basis_vector(self) -> Vec:
        return _scaled(self.r, self.r_norm, self.dt)

    def record(self, i_used: int, est) -> bool:
        """Step i_used - 1's estimate into the history; whether the
        cycle goes on (the JAX package's `active`)."""
        self.norms[self.it + i_used] = est
        return est > self.eps and self.it + i_used < self.max_iter

    def restart(self, x: Vec, i_used: int) -> None:
        """The true residual of the new iterate x (gmres.c:677-678) ends
        the cycle: it overwrites the history at it0 + i_used; the solve
        stops on convergence, on a cycle that took no step, or at
        max_iter."""
        self.x = x
        self.r = tsub(self.b, self.A(x))
        self.r_norm = tnorm2(self.r).cpu().numpy()[()]
        self.it += i_used
        self.norms[self.it] = self.r_norm
        self.converged = bool(self.r_norm <= self.eps)
        self.done = self.converged or i_used == 0 or self.it >= self.max_iter

    def result(self, edge) -> SolverResult:
        """The solve's result, x back in the caller's vector structure."""
        dev = self.b.device
        rel = self.r_norm / (self.den if self.den > 0 else self.dt(1))
        return SolverResult(
            x=edge.unflat(self.x),
            num_iterations=self.it,
            rel_residual_norm=torch.tensor(rel, dtype=self.b.dtype,
                                           device=dev),
            converged=self.converged,
            res_norms=torch.from_numpy(self.norms).to(dev),
        )


def _on_device(y: np.ndarray, like: Vec) -> torch.Tensor:
    return torch.from_numpy(y).to(like.device)


def gmres(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: GMRESOptions = GMRESOptions(),
) -> SolverResult:
    edge, A, b, x0, M = flat_problem(A, b, x0, M)
    kd = int(opts.k_dim)
    st = _Restarts(A, b, x0, opts)
    while st.running():
        V = b.new_zeros((kd + 1,) + tuple(b.shape))
        V[0] = st.first_basis_vector()
        hs = _Hessenberg(kd, st.dt, st.r_norm)
        i_used = 0
        for i in range(kd):
            w, h = _mgs(V, A(M(V[i])), i)
            V[i + 1] = _scaled(w, h[-1], st.dt)
            i_used = i + 1
            if not st.record(i_used, hs.add_column(i, h)):
                break
        # x += M (V y)   (right preconditioning, gmres.c:655-668)
        y = _on_device(hs.solve(i_used), b)
        st.restart(st.x + M(y @ V[:kd]), i_used)
    return st.result(edge)
