"""ADS — auxiliary-space divergence solver for face (RT0) elements
(port of hypre_tpu/solvers/amg/ads.py).

Reference: parcsr_ls/ads.c (1402 LoC), stacked on AMS: for
A = div-div + mass on faces, combine
  * a smoother on A (l1-Jacobi here)
  * a curl-space correction  C B_C C^T with B_C = AMS on A_C = C^T A C
  * a vector-nodal correction Pi B_Pi Pi^T, Pi = RT0 interpolation,
    B_Pi = AMG on A_Pi = Pi^T A Pi
multiplicative cycle 01210 like AMS.  The setup is the JAX package's
host code, line for line; the operators and the auxiliary solvers live
on `device`, applied as in ams.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import (freeze_auto, kernel_launches, spmv, spmv_axpy,
                        spmv_jacobi, spmv_resid, sum_launches)
from ..krylov.common import SolverResult
from .ams import AMS, AMSOptions, _fix_zero_diagonal
from .boomeramg import BoomerAMG, BoomerAMGOptions


@dataclasses.dataclass(frozen=True)
class ADSOptions:
    ams: AMSOptions = AMSOptions()
    amg: BoomerAMGOptions = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18,
    )
    smooth_sweeps: int = 1


class ADS:
    def __init__(self, A: CSRMatrix, C: CSRMatrix, Pi: CSRMatrix,
                 G: CSRMatrix, coords: np.ndarray,
                 opts: ADSOptions = ADSOptions(), *, device="cuda"):
        self.opts = opts
        self.device = dev = torch.device(device)
        As = A.to_scipy()
        Cs = C.to_scipy()
        Pis = Pi.to_scipy()
        dt = torch_dtype(As.dtype.name)
        self._E = freeze_auto(A, dt, dev)
        l1 = np.asarray(np.abs(As).sum(axis=1)).ravel()
        self._l1inv = to_device(
            np.where(l1 == 0, 0.0, 1.0 / np.where(l1 == 0, 1, l1)), dt, dev)

        # curl space: A_C = C^T A C, preconditioned by AMS
        AC = _fix_zero_diagonal((Cs.T @ As @ Cs).tocsr())
        self._C = freeze_auto(C, dt, dev)
        self._CT = freeze_auto(CSRMatrix.from_scipy(Cs.T.tocsr()), dt, dev)
        self._ams = AMS(CSRMatrix.from_scipy(AC.tocsr()), G, coords, opts.ams,
                        device=dev)

        # RT nodal space
        APi = _fix_zero_diagonal((Pis.T @ As @ Pis).tocsr())
        self._Pi = freeze_auto(Pi, dt, dev)
        self._PiT = freeze_auto(CSRMatrix.from_scipy(Pis.T.tocsr()), dt, dev)
        self._amg_Pi = BoomerAMG(CSRMatrix.from_scipy(APi.tocsr()), opts.amg,
                                 device=dev)

    def _smooth(self, u, b):
        for _ in range(self.opts.smooth_sweeps):
            u = spmv_jacobi(self._E, self._l1inv, u, b, 1.0)
        return u

    def _curl(self, u, b):
        return spmv_axpy(self._C, self._ams.precond(
            spmv(self._CT, spmv_resid(self._E, u, b))), u)

    def precond(self, b):
        u = torch.zeros_like(b)
        u = self._smooth(u, b)
        u = self._curl(u, b)
        u = spmv_axpy(self._Pi, self._amg_Pi.cycle(
            spmv(self._PiT, spmv_resid(self._E, u, b))), u)
        u = self._curl(u, b)
        u = self._smooth(u, b)
        return u

    def apply_launches(self) -> dict:
        """{kernel name: launches} of one `precond` application."""
        return sum_launches([
            (kernel_launches(self._E), 2 * self.opts.smooth_sweeps + 3),
            (kernel_launches(self._CT), 2), (self._ams.apply_launches(), 2),
            (kernel_launches(self._C), 2), (kernel_launches(self._PiT), 1),
            (self._amg_Pi.cycle_launches(), 1), (kernel_launches(self._Pi), 1)])

    def solve(self, b, tol=1e-6, max_iter=200) -> SolverResult:
        from ..krylov import PCGOptions, pcg

        return pcg(lambda x: spmv(self._E, x), b, M=self.precond,
                   opts=PCGOptions(tol=tol, max_iter=max_iter))
