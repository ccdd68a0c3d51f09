"""Flexible GMRES (port of hypre_tpu/solvers/krylov/flexgmres.py).

Reference: krylov/flexgmres.c — restarted GMRES whose preconditioner may
change from step to step: the preconditioned vectors z_j = M_j v_j are
stored and the correction is x += sum_j y_j z_j, with no final
preconditioner application.  k_dim default 5.  The loop, counts and
history are gmres.py's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from .common import SolverResult, Vec, flat_problem
from .gmres import _Hessenberg, _mgs, _on_device, _Restarts, _scaled


@dataclasses.dataclass(frozen=True)
class FlexGMRESOptions:
    tol: float = 1e-6
    a_tol: float = 0.0
    max_iter: int = 1000
    k_dim: int = 5


def flexgmres(
    A: Callable[[Vec], Vec],
    b: Vec,
    x0: Optional[Vec] = None,
    M: Optional[Callable[[Vec], Vec]] = None,
    opts: FlexGMRESOptions = FlexGMRESOptions(),
) -> SolverResult:
    edge, A, b, x0, M = flat_problem(A, b, x0, M)
    kd = int(opts.k_dim)
    st = _Restarts(A, b, x0, opts)
    while st.running():
        V = b.new_zeros((kd + 1,) + tuple(b.shape))
        Z = b.new_zeros((kd,) + tuple(b.shape))  # the stored M v_j
        V[0] = st.first_basis_vector()
        hs = _Hessenberg(kd, st.dt, st.r_norm)
        i_used = 0
        for i in range(kd):
            Z[i] = M(V[i])
            w, h = _mgs(V, A(Z[i]), i)
            V[i + 1] = _scaled(w, h[-1], st.dt)
            i_used = i + 1
            if not st.record(i_used, hs.add_column(i, h)):
                break
        y = _on_device(hs.solve(i_used), b)
        st.restart(st.x + y @ Z, i_used)
    return st.result(edge)
