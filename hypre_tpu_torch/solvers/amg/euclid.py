"""Euclid-shape parallel ILU(k): subdomain graph + colored block solves
(port of hypre_tpu/solvers/amg/euclid.py).

Reference: distributed_ls/Euclid/ — SubdomainGraph_dh.c builds the
subdomain adjacency graph of the row-block decomposition and colors it
(greedy, by subdomain id) so that PILU elimination can order boundary
rows by color; ilu_seq.c factors each subdomain's interior; Euclid
applies the factors as a parallel preconditioner/smoother.  hypre
exposes it as BoomerAMG smooth_type 9 (par_amg.h smooth_type,
par_cycle.c: levels below smooth_num_levels smooth with the aux
smoother INSTEAD of relaxation).

Subdomains are contiguous row blocks (hypre's own model — one per
rank).  Each block's DIAGONAL sub-block is factored ILU(k); the factors
assemble block-diagonally, so ONE global pair of wavefront schedules
(relax.py) applies every domain's triangular solves at once — on the
card two launches of the gs_sweep kernel.  Two application modes:

  * additive (block-Jacobi): u += w * B^{-1} r;
  * multiplicative by COLOR: colors run sequentially, all domains of
    one color update together from a fresh residual — a colored block
    Gauss-Seidel, one residual and one masked apply per color.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .ilu import ilu0_factor, iluk_factor, triangular_pair, triangular_solve
from .relax import GSSchedule


def subdomain_graph(A: sp.csr_matrix, bounds: np.ndarray):
    """Adjacency of row-block subdomains (SubdomainGraph_dh role):
    i ~ j iff any coupling crosses the two blocks."""
    D = len(bounds) - 1
    Ac = A.tocoo()
    dom_r = np.searchsorted(bounds[1:], Ac.row, side="right")
    dom_c = np.searchsorted(bounds[1:], Ac.col, side="right")
    adj = [set() for _ in range(D)]
    cross = dom_r != dom_c
    for a, b in zip(dom_r[cross], dom_c[cross]):
        adj[a].add(int(b))
        adj[b].add(int(a))
    return adj


def color_subdomains(adj) -> np.ndarray:
    """Greedy coloring in subdomain-id order (SubdomainGraph_dh.c's
    ordering); returns color per domain."""
    D = len(adj)
    color = np.full(D, -1, dtype=np.int64)
    for d in range(D):
        used = {int(color[nb]) for nb in adj[d] if color[nb] >= 0}
        c = 0
        while c in used:
            c += 1
        color[d] = c
    return color


@dataclasses.dataclass(frozen=True)
class EuclidData:
    Lsched: GSSchedule
    Usched: GSSchedule
    color_of_row: torch.Tensor  # int32 [n]
    ncolors: int
    colored: bool


def build_euclid(
    A: sp.csr_matrix,
    num_domains: int = 4,
    fill_level: int = 1,
    colored: bool = True,
    *,
    device="cuda",
) -> EuclidData:
    """Factor the block-diagonal part per subdomain + schedules on
    `device`."""
    A = A.tocsr()
    n = A.shape[0]
    D = max(1, min(num_domains, n))
    bounds = np.linspace(0, n, D + 1).astype(np.int64)
    adj = subdomain_graph(A, bounds)
    color = color_subdomains(adj)
    ncolors = int(color.max()) + 1 if D else 1

    Ls, Us = [], []
    for d in range(D):
        lo, hi = bounds[d], bounds[d + 1]
        blk = A[lo:hi, lo:hi].tocsr()
        if fill_level == 0:
            L, U = ilu0_factor(blk)
        else:
            L, U = iluk_factor(blk, fill_level)
        Ls.append(L)
        Us.append(U)
    Lb = sp.block_diag(Ls, format="csr")
    Ub = sp.block_diag(Us, format="csr")
    Lb.sort_indices()
    Ub.sort_indices()
    Lsched, Usched = triangular_pair(Lb, Ub, device)
    row_dom = np.searchsorted(bounds[1:], np.arange(n), side="right")
    return EuclidData(
        Lsched=Lsched,
        Usched=Usched,
        color_of_row=torch.from_numpy(
            color[row_dom].astype(np.int32)).to(device),
        ncolors=ncolors,
        colored=bool(colored),
    )


def euclid_apply(ed: EuclidData, r):
    """B^{-1} r (all domains at once: block-diagonal triangular pair)."""
    return triangular_solve(ed.Lsched, ed.Usched, r)


def euclid_smooth(ed: EuclidData, matvec, u, f, weight=1.0):
    """One Euclid smoothing sweep.

    colored=False: block-Jacobi  u += w * B^{-1} (f - A u).
    colored=True: colored block GS — per color c (sequential), domains
    of color c update from the CURRENT residual; other rows' updates
    are masked out.
    """
    if not ed.colored:
        r = f - matvec(u)
        return u + weight * euclid_apply(ed, r)
    for c in range(ed.ncolors):
        r = f - matvec(u)
        upd = euclid_apply(ed, r)
        u = u + torch.where(ed.color_of_row == c, weight * upd, 0.0)
    return u
