"""COGMRES, communication-optimized GMRES (port of
hypre_tpu/solvers/krylov/cogmres.py).

Reference: krylov/cogmres.c — GMRES with classical Gram-Schmidt by mass
inner products (one batched reduction an Arnoldi step instead of i + 1
sequential ones, :516-533), CGS-2 reorthogonalization with cgs = 2, and
mass axpys.  A mass dot is one [i + 1, n] x [n] product (ops/blas1.py).
The loop, counts and history are gmres.py's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ...ops.blas1 import mass_axpy, mass_inner_prod
from .common import SolverResult, Vec, flat_problem, tnorm2
from .gmres import _Hessenberg, _on_device, _Restarts, _scaled


@dataclasses.dataclass(frozen=True)
class COGMRESOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    k_dim: int = 5
    cgs: int = 1  # 2 = CGS-2 reorthogonalization


def _cgs(V: torch.Tensor, w: Vec, i: int, passes: int):
    """w orthogonalized against V[0..i] by classical Gram-Schmidt,
    `passes` batched passes whose coefficients add up; returns (w,
    [h_0i .. h_ii, ||w||] on the host)."""
    Vi = V[:i + 1]
    h = mass_inner_prod(w, Vi)
    w = mass_axpy(-h, Vi, w)
    for _ in range(passes - 1):
        h2 = mass_inner_prod(w, Vi)
        w = mass_axpy(-h2, Vi, w)
        h = h + h2
    return w, torch.cat([h, tnorm2(w)[None]]).cpu().numpy()


def cogmres(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: COGMRESOptions = COGMRESOptions(),
) -> SolverResult:
    edge, A, b, x0, M = flat_problem(A, b, x0, M)
    kd = int(opts.k_dim)
    passes = 2 if opts.cgs > 1 else 1
    st = _Restarts(A, b, x0, opts)
    while st.running():
        V = b.new_zeros((kd + 1,) + tuple(b.shape))
        V[0] = st.first_basis_vector()
        hs = _Hessenberg(kd, st.dt, st.r_norm)
        i_used = 0
        for i in range(kd):
            w, h = _cgs(V, A(M(V[i])), i, passes)
            V[i + 1] = _scaled(w, h[-1], st.dt)
            i_used = i + 1
            if not st.record(i_used, hs.add_column(i, h)):
                break
        y = _on_device(hs.solve(i_used), b)
        st.restart(st.x + M(y @ V[:kd]), i_used)
    return st.result(edge)
