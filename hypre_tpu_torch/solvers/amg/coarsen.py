"""PMIS C/F coarsening (port of
hypre_tpu/solvers/amg/coarsen.py::pmis_coarsen).

Reference: parcsr_ls/par_coarsen.c hypre_BoomerAMGCoarsenPMISHost
(:2031-2738):
  * measure[i] = (# rows whose strong set contains i) + LCG random in
    (0,1] (par_indepset.c:33-62, seed 2747)
  * rows with no strong connections at all -> SF_PT (isolated fine)
  * IS selection: candidate iff measure > 1; a candidate is removed iff
    an S u S^T neighbor candidate has a strictly larger measure
  * F assignment: measure < 1, or some strong influencer is C
The iterated independent-set loop runs in the native kernel.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

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


def pmis_coarsen(S: sp.csr_matrix, seed: int = _PMIS_SEED) -> np.ndarray:
    """Returns CF_marker (C_PT / F_PT / SF_PT per row)."""
    n = S.shape[0]
    measure = _measures(S, seed)
    cf = np.zeros(n, dtype=np.int64)
    isolated = np.diff(S.indptr) == 0  # no strong connections in the row
    cf[isolated] = SF_PT
    measure[isolated] = 0.0
    return native.pmis_loop(S.indptr, S.indices, n, measure, cf, True)
