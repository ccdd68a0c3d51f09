"""Smoothed-aggregation AMG, the FEI_mv/femli MLI role (port of
hypre_tpu/solvers/amg/smoothed_aggregation.py).

Reference: FEI_mv/femli (~40 kLoC C++ smoothed aggregation).  Classic
SA: greedy strength-based aggregation, tentative piecewise-constant
P_tent (near-null-space vector per aggregate), damped-Jacobi prolongator
smoothing P = (I - omega D^{-1} A) P_tent, Galerkin RAP.

The setup is the JAX package's host numpy / scipy, line for line; every
level's A, P and R is frozen by `freeze_auto` in the operator's own
dtype onto `device` (on the card: K1, the ELL kernel or a dense
product), the coarsest level keeps its dense pinv.  The V-cycle runs
the SpMV kernels' fused forms: each Jacobi sweep is one `spmv_jacobi`,
the residual one `spmv_resid`, the prolongation one `spmv_axpy`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import (freeze_auto, kernel_launches, spmv, spmv_axpy,
                        spmv_jacobi, spmv_resid, sum_launches)
from .strength import strength_matrix


@dataclasses.dataclass(frozen=True)
class SAOptions:
    theta: float = 0.08  # SA strength drop (scaled |a_ij|^2 test classic)
    omega: float = 2.0 / 3.0  # prolongator smoothing damping
    max_levels: int = 20
    max_coarse_size: int = 32
    num_sweeps: int = 1
    jacobi_weight: float = 2.0 / 3.0


def _aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy root-based aggregation (femli MLI_AggrAMG style):
    pass 1 roots with unaggregated neighborhoods; pass 2 attach leftovers."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    na = 0
    indptr, indices = S.indptr, S.indices
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = na
            agg[nbrs] = na
            na += 1
    # pass 2: attach to an adjacent aggregate
    for i in range(n):
        if agg[i] == -1:
            nbrs = indices[indptr[i] : indptr[i + 1]]
            done = nbrs[agg[nbrs] != -1]
            if done.size:
                agg[i] = agg[done[0]]
            else:
                agg[i] = na
                na += 1
    return agg


class SmoothedAggregationAMG:
    """Host setup; the levels (dicts of A, dinv, P, R, coarse_inv) live
    on `device`.  `host_levels` keeps each level's host A and aggregates
    for inspection."""

    def __init__(self, A: CSRMatrix, opts: SAOptions = SAOptions(),
                 near_null: np.ndarray | None = None, *, device="cuda"):
        self.opts = opts
        self.device = torch.device(device)
        self.levels = []  # list of dicts {A, dinv, P, R, coarse_inv}
        self.host_levels = []  # list of dicts {A, agg}
        As = A.to_scipy().tocsr()
        dt = torch_dtype(As.dtype.name)
        dev = self.device
        o = opts
        nn = near_null if near_null is not None else np.ones(As.shape[0])
        for l in range(o.max_levels):
            n = As.shape[0]
            diag = As.diagonal()
            dinv = np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1, diag))
            if n <= o.max_coarse_size:
                self.levels.append(dict(
                    A=freeze_auto(CSRMatrix.from_scipy(As), dt, dev),
                    dinv=to_device(dinv, dt, dev),
                    coarse_inv=to_device(
                        np.linalg.pinv(As.toarray(), rcond=1e-12), dt, dev),
                    P=None, R=None,
                ))
                self.host_levels.append(dict(A=As, agg=None))
                break
            S = strength_matrix(CSRMatrix.from_scipy(As), o.theta, 1.0)
            agg = _aggregate(S)
            na = int(agg.max()) + 1
            # tentative prolongator with near-null-space normalization
            Pt = sp.coo_matrix((nn, (np.arange(n), agg)), shape=(n, na)).tocsr()
            norms = np.sqrt(np.asarray(Pt.multiply(Pt).sum(axis=0))).ravel()
            norms[norms == 0] = 1.0
            Pt = (Pt @ sp.diags(1.0 / norms)).tocsr()
            nn = norms  # coarse near-null vector
            # smooth: P = (I - omega D^{-1} A) P_tent
            P = (Pt - o.omega * (sp.diags(dinv) @ As @ Pt)).tocsr()
            Ac = (P.T @ As @ P).tocsr()
            self.levels.append(dict(
                A=freeze_auto(CSRMatrix.from_scipy(As), dt, dev),
                dinv=to_device(dinv, dt, dev),
                P=freeze_auto(CSRMatrix.from_scipy(P), dt, dev),
                R=freeze_auto(CSRMatrix.from_scipy(P.T.tocsr()), dt, dev),
                coarse_inv=None,
            ))
            self.host_levels.append(dict(A=As, agg=agg))
            As = Ac

    def cycle(self, f, u=None):
        return self._vc(0, torch.zeros_like(f) if u is None else u, f)

    def _vc(self, l, u, f):
        o = self.opts
        lv = self.levels[l]
        if lv["P"] is None:
            return lv["coarse_inv"] @ f
        w = o.jacobi_weight
        for _ in range(o.num_sweeps):
            u = spmv_jacobi(lv["A"], lv["dinv"], u, f, w)
        r = spmv_resid(lv["A"], u, f)
        ec = self._vc(l + 1, f.new_zeros(lv["R"].num_rows), spmv(lv["R"], r))
        u = spmv_axpy(lv["P"], ec, u)
        for _ in range(o.num_sweeps):
            u = spmv_jacobi(lv["A"], lv["dinv"], u, f, w)
        return u

    def cycle_launches(self) -> dict:
        """{kernel name: launches} of one `cycle` (ops/dia.py::
        kernel_launches of each operator application)."""
        sweeps = 2 * self.opts.num_sweeps + 1  # the sweeps and the residual
        return sum_launches(
            (kernel_launches(A), k) for lv in self.levels[:-1]
            for A, k in ((lv["A"], sweeps), (lv["R"], 1), (lv["P"], 1)))

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    @property
    def num_levels(self):
        return len(self.levels)
