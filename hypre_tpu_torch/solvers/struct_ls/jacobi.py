"""Struct Jacobi solver (port of hypre_tpu/solvers/struct_ls/jacobi.py;
reference: struct_ls/jacobi.c — pointwise Jacobi iteration as a
standalone StructSolver, used by SStruct Split).

The JAX package's `lax.while_loop` is a host loop here that reads the
stop flag once an iteration.  On a sharded grid
(parallel/par_struct.py::shard_solver) the product exchanges and the
dots add the shards' dots in shard order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...struct.matrix import StructMatrix, struct_matvec
from ..krylov.common import SolverResult, tdot, tfirst, tsub, tzeros_like
from .relax import point_jacobi


@dataclasses.dataclass(frozen=True)
class StructJacobiOptions:
    tol: float = 1e-6
    max_iter: int = 1000
    weight: float = 1.0


def inverse_diagonal(A: StructMatrix, device) -> torch.Tensor:
    """1 / diag(A), 0 where the diagonal is 0 (computed on the host)."""
    diag = A.diagonal().cpu().numpy()
    return torch.from_numpy(
        np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1, diag))
    ).to(device)


class StructJacobi:
    def __init__(self, A: StructMatrix,
                 opts: StructJacobiOptions = StructJacobiOptions(), *,
                 device=None):
        """`device`: where the solve runs (None: A's device)."""
        self.A = A if device is None else A.to(device)
        self.opts = opts
        self.dinv = inverse_diagonal(self.A, self.A.device)

    def solve(self, b, x0=None) -> SolverResult:
        o = self.opts
        x = tzeros_like(b) if x0 is None else x0
        b_dot_b = tdot(b, b)
        bb = torch.where(b_dot_b > 0, b_dot_b, 1.0)
        eps = o.tol**2
        b0 = tfirst(b)
        norms = torch.full((o.max_iter + 1,), float("nan"), dtype=b0.dtype,
                           device=b0.device)
        rr = torch.tensor(float("inf"), dtype=b0.dtype, device=b0.device)
        i, done = 0, False
        while i < o.max_iter and not done:
            x = point_jacobi(self.A, self.dinv, x, b, o.weight)
            r = tsub(b, struct_matvec(self.A, x))
            rr = tdot(r, r)
            norms[i + 1] = torch.sqrt(rr)
            done = bool(rr / bb < eps)
            i += 1
        return SolverResult(x, i, torch.sqrt(rr / bb), done, norms)
