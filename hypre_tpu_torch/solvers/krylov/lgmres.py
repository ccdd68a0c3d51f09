"""LGMRES, GMRES augmented with error-approximation vectors (port of
hypre_tpu/solvers/krylov/lgmres.py).

Reference: krylov/lgmres.c (aug_dim 2 at :101).  A cycle's basis holds
it_arnoldi = k_dim - aug_ct Krylov directions of A M, then aug_ct stored
directions a = (A M) z of the last cycles' corrections z
(lgmres.c:513-560); the cycle's combined correction w (the Krylov part
over V, the augmented part over the stored z, :635-662) becomes the next
augmentation vector before preconditioning (:665), and x += M w
(:668-672).  The stored pairs are a ring of aug_dim slots written at
aug_ct % aug_dim, as in the JAX package (once full, slot 0 is the one
rewritten).  The loop, counts and history are gmres.py's; an augmented
step applies no operator, and the last cycle stores no new pair.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .common import SolverResult, Vec, flat_problem, tnorm2
from .gmres import _Hessenberg, _mgs, _on_device, _Restarts, _scaled


@dataclasses.dataclass(frozen=True)
class LGMRESOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    k_dim: int = 20
    aug_dim: int = 2


def lgmres(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: LGMRESOptions = LGMRESOptions(),
) -> SolverResult:
    edge, A, b, x0, M = flat_problem(A, b, x0, M)
    kd, ad = int(opts.k_dim), int(opts.aug_dim)
    st = _Restarts(A, b, x0, opts)
    aug_z = b.new_zeros((ad,) + tuple(b.shape))  # corrections z (before M)
    aug_a = b.new_zeros((ad,) + tuple(b.shape))  # their images A M z
    aug_ct = 0
    while st.running():
        it_arnoldi = kd - aug_ct
        aug_used = min(aug_ct, ad)
        V = b.new_zeros((kd + 1,) + tuple(b.shape))
        V[0] = st.first_basis_vector()
        hs = _Hessenberg(kd, st.dt, st.r_norm)
        i_used = 0
        for i in range(kd):
            if i >= it_arnoldi:
                w = aug_a[min(max(i - it_arnoldi, 0), ad - 1)]
            else:
                w = A(M(V[i]))
            w, h = _mgs(V, w, i)
            V[i + 1] = _scaled(w, h[-1], st.dt)
            i_used = i + 1
            if not (st.record(i_used, hs.add_column(i, h))
                    and i_used < it_arnoldi + aug_used):
                break
        y = hs.solve(i_used)
        # the Krylov columns combine V, the augmented ones the stored z
        col = np.arange(kd)
        y_kry = np.where(col < it_arnoldi, y, 0.0).astype(st.dt)
        coef = np.zeros(ad, dtype=st.dt)
        for j in range(aug_used):
            coef[j] = y[min(it_arnoldi + j, kd - 1)]
        w = _on_device(y_kry, b) @ V[:kd] + _on_device(coef, b) @ aug_z
        st.restart(st.x + M(w), i_used)
        if st.done:
            break
        slot = aug_ct % ad
        aug_z[slot] = _scaled(w, tnorm2(w).cpu().numpy()[()], st.dt)
        aug_a[slot] = A(M(aug_z[slot]))
        aug_ct = min(aug_ct + 1, ad)
    return st.result(edge)
