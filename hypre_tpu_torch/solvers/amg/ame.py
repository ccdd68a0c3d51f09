"""AME — Maxwell eigensolver, LOBPCG + AMS (port of
hypre_tpu/solvers/amg/ame.py).

Reference: parcsr_ls/ame.c (638 LoC): smallest eigenpairs of the
curl-curl operator A x = lambda M x on the divergence-free subspace;
LOBPCG preconditioned by AMS, with iterates kept M-orthogonal to the
gradient space (x <- x - G (G^T M G)^{-1} G^T M x each iteration).

The setup is the JAX package's host code; A, M, G, G^T, the AMS and the
BoomerAMG of K = G^T M G live on `device`.  The start block is the JAX
package's numpy draw (`np.random.default_rng(2747)`), so both packages
start LOBPCG from the same vectors.  The multivector operators apply A,
M and AMS a column at a time (a column of an [n, m] block is copied
contiguous for the kernels); `applications` counts those columns and
`inner_iterations` the inner AMG-PCG iterations of every projected
column, so a caller can predict the kernels' launches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, torch_dtype
from ...ops.dia import freeze_auto, spmv, spmv_axpy
from ..eigen import LOBPCGOptions, LOBPCGResult, lobpcg
from ..krylov import PCGOptions, pcg
from .ams import AMS, AMSOptions, _fix_zero_diagonal
from .boomeramg import BoomerAMG, BoomerAMGOptions

AME_SEED = 2747  # the start block's numpy seed (the JAX package's)


@dataclasses.dataclass(frozen=True)
class AMEOptions:
    nev: int = 4
    tol: float = 1e-6
    max_iter: int = 200
    ams: AMSOptions = AMSOptions()


class AME:
    def __init__(
        self,
        A: CSRMatrix,
        M: CSRMatrix,
        G: CSRMatrix,
        coords: np.ndarray,
        opts: AMEOptions = AMEOptions(),
        *,
        device="cuda",
    ):
        self.opts = opts
        self.device = dev = torch.device(device)
        dt = torch_dtype(A.data.dtype.name)
        self.ams = AMS(A, G, coords, opts.ams, device=dev)
        self._E = freeze_auto(A, dt, dev)
        self._Em = freeze_auto(M, dt, dev)
        Gs = G.to_scipy()
        Ms = M.to_scipy()
        # gradient-space projector pieces: K = G^T M G (nodal SPD)
        K = _fix_zero_diagonal((Gs.T @ Ms @ Gs).tocsr())
        self._G = freeze_auto(G, dt, dev)
        self._GT = freeze_auto(CSRMatrix.from_scipy(Gs.T.tocsr()), dt, dev)
        self._amg_K = BoomerAMG(
            CSRMatrix.from_scipy(K.tocsr()),
            BoomerAMGOptions(coarsen_type="pmis", interp_type="ext+i",
                             P_max_elmts=4, relax_down=18, relax_up=18),
            device=dev,
        )
        self.applications = {"A": 0, "B": 0, "T": 0}
        self.inner_iterations: list[int] = []

    def _columns(self, key, fn, X):
        self.applications[key] += X.shape[1]
        return torch.stack([fn(X[:, k].contiguous())
                            for k in range(X.shape[1])], dim=1)

    def _project(self, X):
        """Remove the gradient component: X -= G K^{-1} G^T M X
        (K^{-1} by a few AMG-PCG digits — ame.c uses an inner PCG)."""
        K0 = self._amg_K.levels[0].A
        cols = []
        for k in range(X.shape[1]):
            xk = X[:, k].contiguous()
            gmx = spmv(self._GT, spmv(self._Em, xk))
            res = pcg(
                lambda v: spmv(K0, v),
                gmx,
                M=self._amg_K.precond,
                opts=PCGOptions(tol=1e-10, max_iter=50),
            )
            self.inner_iterations.append(res.num_iterations)
            cols.append(spmv_axpy(self._G, -res.x, xk))
        return torch.stack(cols, dim=1)

    def solve(self, X0=None) -> LOBPCGResult:
        o = self.opts
        n = self._E.num_rows
        # guard vectors resolve degenerate clusters (the lobpcg.c
        # blockSize-over-nev practice)
        m = o.nev + 2
        if X0 is None:
            X0 = torch.from_numpy(
                np.random.default_rng(AME_SEED).standard_normal((n, m))
            ).to(self.device, self._E.data.dtype)

        Aop = lambda X: self._columns("A", lambda x: spmv(self._E, x), X)
        Bop = lambda X: self._columns("B", lambda x: spmv(self._Em, x), X)
        T = lambda R: self._project(self._columns("T", self.ams.precond, R))

        X0 = self._project(X0)
        res = lobpcg(
            Aop, X0, B=Bop, T=T,
            opts=LOBPCGOptions(tol=o.tol, max_iter=o.max_iter),
        )
        return dataclasses.replace(
            res,
            eigenvalues=res.eigenvalues[: o.nev],
            eigenvectors=res.eigenvectors[:, : o.nev],
            residual_norms=res.residual_norms[: o.nev],
        )
