"""C/F coarsening: PMIS, HMIS, Ruge-Stueben, CLJP, Falgout and
compatible relaxation (port of hypre_tpu/solvers/amg/coarsen.py).

Reference: parcsr_ls/par_coarsen.c hypre_BoomerAMGCoarsenPMISHost
(:2031-2738):
  * measure[i] = (# rows whose strong set contains i) + LCG random in
    (0,1] (par_indepset.c:33-62, seed 2747)
  * rows with no strong connections at all -> SF_PT (isolated fine)
  * IS selection: candidate iff measure > 1; a candidate is removed iff
    an S u S^T neighbor candidate has a strictly larger measure
  * F assignment: measure < 1, or some strong influencer is C
The iterated independent-set loop runs in the native kernel, as do the
Ruge-Stueben first pass (hypre_BoomerAMGCoarsenRuge, :874) and CLJP
(hypre_BoomerAMGCoarsen, :93).  HMIS is the RS pass followed by PMIS
with CF_init (:2763-2790); CR is par_cr.c's compatible relaxation.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ... import native
from ...utils.lcg import lcg_fill

C_PT = 1
F_PT = -1
SF_PT = -3

_PMIS_SEED = 2747  # par_indepset.c:46


def _measures(S: sp.csr_matrix, seed: int = _PMIS_SEED) -> np.ndarray:
    n = S.shape[0]
    col_count = np.bincount(S.indices, minlength=n).astype(np.float64)
    return col_count + lcg_fill(seed, n)


def pmis_coarsen(S: sp.csr_matrix, cf_init: np.ndarray | None = None,
                 seed: int = _PMIS_SEED,
                 isolated_to_c: bool = False) -> np.ndarray:
    """Returns CF_marker (C_PT / F_PT / SF_PT per row).  cf_init: a
    preset marker (HMIS, the reference's CF_init 1): its nonzero
    entries are kept and the first independent-set round is skipped
    (par_coarsen.c:2424 `!CF_init || iter`).  isolated_to_c: rows with
    no strong connection become C, not SF (CF_init 3, the aggressive
    second round, par_coarsen.c:2323: an isolated first-round C point
    has nothing to interpolate from and stays coarse)."""
    n = S.shape[0]
    measure = _measures(S, seed)
    if cf_init is None:
        cf = np.zeros(n, dtype=np.int64)
        isolated = np.diff(S.indptr) == 0  # no strong connections in the row
        cf[isolated] = C_PT if isolated_to_c else SF_PT
        measure[isolated] = 0.0
        return native.pmis_loop(S.indptr, S.indices, n, measure, cf, True)
    cf = cf_init.astype(np.int64).copy()
    measure[cf != 0] = 0.0
    return native.pmis_loop(S.indptr, S.indices, n, measure, cf, False)


def ruge_stuben_coarsen(S: sp.csr_matrix) -> np.ndarray:
    """The serial first pass of classical Ruge-Stueben coarsening
    (par_coarsen.c:874): repeatedly make the unassigned point of largest
    measure (|S^T row|) C, the points it influences F, and raise the
    measures of their other influencers (a bucket list by measure)."""
    return native.rs_coarsen(S)


def hmis_coarsen(S: sp.csr_matrix, seed: int = _PMIS_SEED) -> np.ndarray:
    """HMIS: the RS first pass, then PMIS on what it left unassigned
    (par_coarsen.c:2763, CF_init 1)."""
    return pmis_coarsen(S, cf_init=ruge_stuben_coarsen(S), seed=seed)


def cljp_coarsen(S: sp.csr_matrix, seed: int = _PMIS_SEED) -> np.ndarray:
    """CLJP coarsening (par_coarsen.c:93); measures |S^T col| + LCG
    random, as PMIS's."""
    return native.cljp_coarsen(S.indptr, S.indices, S.shape[0],
                               _measures(S, seed))


def falgout_coarsen(S: sp.csr_matrix, seed: int = _PMIS_SEED) -> np.ndarray:
    """Falgout coarsening (par_coarsen.c:1992): the RS first pass, then
    CLJP on the points it left unsettled across subdomains.  On one
    subdomain RS settles every point, so this is RS."""
    return ruge_stuben_coarsen(S)


def cr_coarsen(A: sp.csr_matrix, theta_cr: float = 0.7, mu: int = 5,
               seed: int = 2747, max_stages: int = 20) -> np.ndarray:
    """Compatible-relaxation coarsening (par_cr.c hypre_cr:72).

    Each stage runs mu forward Gauss-Seidel sweeps on the F-point block
    of the homogeneous system (C values pinned to 0, hypre_fptgscr) and
    measures rho = ||e1|| / ||e0||; while rho > theta_cr, the slow
    points (|e_i| / max > 1 - rho, hypre_formu:450) become candidates
    and a greedy independent set of them becomes C
    (hypre_IndepSetGreedy:179, measure 1 + # candidate neighbors).  The
    F-point errors start at 1 + 0.1 * rand (the Park-Miller stream) and
    are drawn afresh after each stage."""
    M = A.tocsr()
    n = M.shape[0]
    indptr, indices = M.indptr, M.indices
    row_nnz = np.diff(indptr)

    cf = np.full(n, F_PT, dtype=np.int64)
    skip = 0
    e1 = 1.0 + 0.1 * lcg_fill(seed, n, skip)
    skip += n
    e0 = np.zeros(n)

    for _ in range(max_stages):
        fmask = cf == F_PT
        e0[~fmask] = 0.0
        e1[~fmask] = 0.0
        fidx = np.flatnonzero(fmask)
        AFF = M[np.ix_(fidx, fidx)].tocsr()
        LFF = sp.tril(AFF, k=0).tocsr()
        UFF = sp.triu(AFF, k=1).tocsr()
        for _ in range(mu):
            e0[fmask] = e1[fmask]
            ef = spla.spsolve_triangular(LFF, -(UFF @ e0[fidx]), lower=True)
            e1 = np.zeros_like(e1)
            e1[fidx] = ef
        n0 = np.linalg.norm(e0)
        rho = np.linalg.norm(e1) / (n0 if n0 > 0 else 1.0)
        if rho <= theta_cr:
            break
        emax = np.abs(e1).max() or 1.0
        cand = fmask & (np.abs(e1) / emax > (1.0 - rho)) & (row_nnz > 1)
        cidx = np.flatnonzero(cand)
        if cidx.size == 0:
            break
        measure = np.zeros(n, dtype=np.int64)
        for i in cidx:
            measure[i] = 1 + int(cand[indices[indptr[i]:indptr[i + 1]]].sum())
        order = np.lexsort((cidx, -measure[cidx]))
        alive = cand.copy()
        for i in cidx[order]:
            if not alive[i]:
                continue
            cf[i] = C_PT
            alive[i] = False
            alive[indices[indptr[i]:indptr[i + 1]]] = False
        fmask = cf == F_PT
        nf = int(fmask.sum())
        e0[fmask] = 1.0 + 0.1 * lcg_fill(seed, nf, skip)
        skip += nf
        e1[fmask] = 1.0 + 0.1 * lcg_fill(seed, nf, skip)
        skip += nf
    return cf
