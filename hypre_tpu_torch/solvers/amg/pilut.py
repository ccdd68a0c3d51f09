"""PILUT — Saad's parallel threshold-ILU with its own Schur pipeline
(port of hypre_tpu/solvers/amg/pilut.py).

Reference: distributed_ls/pilut/ (~7 kLoC: ilut.c serial row
factorization, parilut.c the parallel elimination, schur complement
formation and the RECURSIVE reduction — the factored interior rows
eliminate into the boundary rows, the reduced boundary system is
re-partitioned and factored again until small).  This differs from the
GMRES-in-Schur variants (ilu.py SchurILU, par_ilu.c): PILUT forms each
stage's approximate Schur complement EXPLICITLY with threshold dropping
and descends, so the apply phase is a pure triangular pipeline with no
inner Krylov iteration.

The factorization is the JAX package's host code, line for line; each
stage's apply operands live on `device`: the triangular solves with
L_BB / U_BB are wavefront-scheduled Gauss-Seidel sweeps (relax.py
GSSchedule; on the card one `gs_sweep` launch each), the couplings
L_EB / U_BF frozen SpMVs, the permutations plain index ops, and the
last system goes to ILUT (ilu.py ILU type 1, two more sweeps).

Stage algebra (rows permuted interior-first, ni interior):
    A_p = [[B, F], [E, C]];  partial ILUT eliminates pivots < ni:
      L = [[L_BB, 0], [L_EB, I]],  U = [[U_BB, U_BF], [0, S]]
    with S ~= C - E B^{-1} F under the (droptol, lfil) drop rule.
    Forward:  y_B = L_BB^{-1} r_B ;  y_S = r_S - L_EB y_B
    Descend:  x_S = next stage applied to y_S (coarsest: full ILUT)
    Back:     x_B = U_BB^{-1} (y_B - U_BF x_S)
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, torch_dtype
from ...ops.dia import (freeze_auto, kernel_launches, spmv, spmv_resid,
                        sum_launches)
from .ilu import ILU, ILUOptions
from .relax import build_gs_schedule, gauss_seidel


def partial_ilut(A: sp.csr_matrix, ni: int, droptol: float = 0.01,
                 lfil: int = 20):
    """Row-based ILUT (Saad's IKJ with dual dropping) that eliminates
    only the first `ni` pivots; rows >= ni come out as the approximate
    Schur complement rows (pilut/parilut.c's interior elimination into
    the boundary).  Returns (L csr n x n unit-lower with cols < ni,
    U csr ni x n upper incl. couplings, S csr nb x nb)."""
    A = A.tocsr()
    A.sort_indices()
    n = A.shape[0]
    nb = n - ni
    U_rows: list[dict] = []  # col -> val for factored rows (i < ni)
    L_ind, L_val, L_ptr = [], [], [0]
    S_ind, S_val, S_ptr = [], [], [0]

    for i in range(n):
        w = dict(zip(A.indices[A.indptr[i]:A.indptr[i + 1]],
                     A.data[A.indptr[i]:A.indptr[i + 1]]))
        norm = np.sqrt(sum(v * v for v in w.values())) or 1.0
        tau = droptol * norm
        lim = min(i, ni)
        # eliminate pivots in increasing column order, INCLUDING fill
        # below the limit created along the way (U rows only have
        # columns >= their pivot, so new pivots always sort after j)
        heap = [j for j in w if j < lim]
        heapq.heapify(heap)
        seen = set(heap)
        li, lv = [], []
        while heap:
            j = heapq.heappop(heap)
            wj = w.pop(j, 0.0)
            if wj == 0.0:
                continue
            uj = U_rows[j]
            f = wj / uj[j]
            if abs(f) < tau:
                continue
            for c, v in uj.items():
                if c == j:
                    continue
                w[c] = w.get(c, 0.0) - f * v
                if c < lim and c not in seen:
                    seen.add(c)
                    heapq.heappush(heap, c)
            li.append(j)
            lv.append(f)
        # drop small fill, keep lfil largest magnitudes per part
        if len(li) > lfil:
            keep = np.argsort(np.abs(lv))[-lfil:]
            li = [li[k] for k in sorted(keep)]
            lv_arr = dict(zip(li, (lv[k] for k in sorted(keep))))
            lv = [lv_arr[j] for j in li]
        L_ind.extend(li)
        L_val.extend(lv)
        L_ptr.append(len(L_ind))

        if i < ni:
            items = [(c, v) for c, v in w.items()
                     if c == i or abs(v) >= tau]
            if len(items) > lfil + 1:
                items.sort(key=lambda cv: (cv[0] != i, -abs(cv[1])))
                items = items[: lfil + 1]
            row = dict(items)
            if i not in row or row[i] == 0.0:
                row[i] = norm * 1e-12  # zero-pivot guard (ilut.c patch)
            U_rows.append(row)
        else:
            items = [(c - ni, v) for c, v in w.items()
                     if c >= ni and (c == i or abs(v) >= tau)]
            if len(items) > lfil + 1:
                items.sort(key=lambda cv: (cv[0] != i - ni, -abs(cv[1])))
                items = items[: lfil + 1]
            items.sort()
            S_ind.extend(c for c, _ in items)
            S_val.extend(v for _, v in items)
            S_ptr.append(len(S_ind))

    L = sp.csr_matrix(
        (np.asarray(L_val), np.asarray(L_ind, dtype=np.int64),
         np.asarray(L_ptr)), shape=(n, n))
    up, ui, ux = [0], [], []
    for i, row in enumerate(U_rows):
        cols = sorted(row)
        ui.extend(cols)
        ux.extend(row[c] for c in cols)
        up.append(len(ui))
    U = sp.csr_matrix(
        (np.asarray(ux), np.asarray(ui, dtype=np.int64), np.asarray(up)),
        shape=(ni, n))
    S = sp.csr_matrix(
        (np.asarray(S_val), np.asarray(S_ind, dtype=np.int64),
         np.asarray(S_ptr)), shape=(nb, nb))
    return L, U, S


@dataclasses.dataclass(frozen=True)
class PILUTOptions:
    num_domains: int = 4
    droptol: float = 1e-3
    lfil: int = 30          # kept entries per factored row part
    min_schur: int = 64     # stop recursing below this
    max_stages: int = 4


class PILUT:
    """Multi-stage PILUT preconditioner (the pilut/ pipeline); the
    stages' operands and the tail ILUT live on `device`."""

    def __init__(self, A: CSRMatrix, opts: PILUTOptions = PILUTOptions(), *,
                 device="cuda"):
        self.opts = opts
        self.device = torch.device(device)
        As = A.to_scipy().tocsr()
        self.stages = []
        D = opts.num_domains
        cur = As
        for _ in range(opts.max_stages):
            n = cur.shape[0]
            if n <= opts.min_schur or D <= 1:
                break
            # interface split (SubdomainGraph role): rows with any
            # coupling that crosses a contiguous-domain boundary
            bounds = np.linspace(0, n, D + 1).astype(np.int64)
            dom = np.searchsorted(bounds[1:], np.arange(n), side="right")
            Ac = cur.tocoo()
            cross = dom[Ac.row] != dom[Ac.col]
            iface = np.zeros(n, bool)
            iface[Ac.row[cross]] = True
            iface[Ac.col[cross]] = True
            int_idx = np.flatnonzero(~iface)
            ifc_idx = np.flatnonzero(iface)
            ni, nb = len(int_idx), len(ifc_idx)
            if ni == 0 or nb == 0 or nb >= n - opts.min_schur // 2:
                break
            perm = np.concatenate([int_idx, ifc_idx])
            Ap = cur[perm][:, perm].tocsr()
            L, U, S = partial_ilut(Ap, ni, opts.droptol, opts.lfil)
            self.stages.append(self._freeze_stage(perm, ni, n, L, U,
                                                  self.device))
            cur = S
            D = max(1, D // 2)
        # coarsest: full ILUT of the remaining system
        self._tail = ILU(
            CSRMatrix.from_scipy(cur.tocsr()),
            ILUOptions(type=1, droptol=opts.droptol,
                       max_row_nnz=opts.lfil),
            device=self.device,
        )

    @staticmethod
    def _freeze_stage(perm, ni, n, L, U, device):
        L_BB = L[:ni, :ni].tocsr() + sp.eye(ni, format="csr")
        L_EB = L[ni:, :ni].tocsr()
        U_BB = U[:, :ni].tocsr()
        U_BF = U[:, ni:].tocsr()
        Ls = build_gs_schedule(
            CSRMatrix.from_scipy(L_BB), forward=True,
            divisor=np.ones(ni), device=device)
        Us = build_gs_schedule(
            CSRMatrix.from_scipy(U_BB), forward=False,
            divisor=U_BB.diagonal(), device=device)
        dt = torch_dtype(L.dtype.name)
        return dict(
            perm=torch.from_numpy(perm.astype(np.int64)).to(device),
            iperm=torch.from_numpy(np.argsort(perm).astype(np.int64)).to(device),
            ni=ni, n=n, Ls=Ls, Us=Us,
            L_EB=freeze_auto(CSRMatrix.from_scipy(L_EB), dt, device),
            U_BF=freeze_auto(CSRMatrix.from_scipy(U_BF), dt, device),
        )

    def _apply(self, k: int, r):
        if k == len(self.stages):
            return self._tail.solve(r)
        st = self.stages[k]
        rp = r[st["perm"]]
        rB, rS = rp[: st["ni"]], rp[st["ni"]:]
        yB = gauss_seidel(st["Ls"], torch.zeros_like(rB), rB)
        yS = spmv_resid(st["L_EB"], yB, rS)
        xS = self._apply(k + 1, yS)
        xB = gauss_seidel(
            st["Us"], torch.zeros_like(yB), spmv_resid(st["U_BF"], xS, yB))
        return torch.cat([xB, xS])[st["iperm"]]

    def solve(self, r):
        return self._apply(0, r)

    @property
    def precond(self):
        return self.solve

    def apply_launches(self) -> dict:
        """{kernel name: launches} of one application: two gs_sweep
        launches a stage and two for the tail ILUT, and each stage's
        coupling matvecs (ops/dia.py::kernel_launches)."""
        return sum_launches(
            [({"gs_sweep": 2 * len(self.stages) + 2}, 1)]
            + [(kernel_launches(st[n]), 1) for st in self.stages
               for n in ("L_EB", "U_BF")])
