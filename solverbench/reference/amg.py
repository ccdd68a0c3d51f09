"""The plain BoomerAMG V-cycle the benchmark holds the program against.

Plain torch sparse CSR (cuSPARSE on the card, the CPU's own kernels
elsewhere), in one dtype throughout: float64 as the configuration states,
or float32 for the control.

Each level's interpolation comes from `interp.py`, which takes from the
program only its C / F split and its choice among equal weights; from
there everything is worked out again here: the coarse operators
A_{l+1} = P^T A_l P from the benchmark's own fine matrix, the
smoothers' divisors, the coarsest level's pseudo-inverse, and the
cycle.

The cycle is hypre's V(1, 1) with a zero initial guess on every level
(par_cycle.c, cycle_type 1, num_sweeps 1):
  down:   relax on A_l u = f_l from u = 0, then f_{l+1} = P^T (f_l - A_l u)
  bottom: u = pinv(A_L) f_L (relax_coarse 9, rcond 1e-12)
  up:     u += P e_{l+1}, then relax once more.
Relaxation: 18 l1-Jacobi, u += w (f - A u) / sum_j |a_ij|; 13 forward
Gauss-Seidel in row order, (D + L) u' = f - U u; 14 backward,
(D + U) u' = f - L u (one process: hypre's hybrid sweeps are plain GS).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

RELAX = (13, 14, 18)

# torch notes on every CSR tensor that its sparse support is in beta
warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|"
                        "invariant checks)", category=UserWarning)


def to_torch_csr(M: sp.spmatrix, dtype, device) -> torch.Tensor:
    """A scipy matrix as a torch sparse CSR tensor (int64 indices)."""
    M = sp.csr_matrix(M)
    M.sort_indices()
    return torch.sparse_csr_tensor(
        torch.from_numpy(M.indptr.astype(np.int64)),
        torch.from_numpy(M.indices.astype(np.int64)),
        torch.from_numpy(M.data.astype(np.float64)),
        size=M.shape).to(device=device, dtype=dtype)


def _coo(A: torch.Tensor):
    """(rows, cols, vals) of a CSR tensor."""
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    rows = torch.repeat_interleave(
        torch.arange(A.shape[0], device=val.device), crow[1:] - crow[:-1])
    return rows, col, val


def _csr(rows, cols, vals, shape) -> torch.Tensor:
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape
                                   ).coalesce().to_sparse_csr()


def galerkin(A: torch.Tensor, P: torch.Tensor,
             PT: torch.Tensor) -> torch.Tensor:
    """P^T A P, computed as P^T (A P)."""
    return PT @ (A @ P)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.mv(A, x)


@dataclasses.dataclass
class Level:
    A: torch.Tensor
    P: torch.Tensor | None = None  # to the next coarser level
    PT: torch.Tensor | None = None
    l1inv: torch.Tensor | None = None
    lower: torch.Tensor | None = None  # D + L (forward GS)
    upper: torch.Tensor | None = None  # D + U (backward GS)
    strict_lower: torch.Tensor | None = None
    strict_upper: torch.Tensor | None = None
    pinv: torch.Tensor | None = None  # the coarsest level's


def _smoother_parts(lvl: Level, relax: set) -> None:
    rows, cols, vals = _coo(lvl.A)
    n = lvl.A.shape[0]
    if 18 in relax:
        l1 = torch.zeros(n, dtype=vals.dtype, device=vals.device)
        l1.index_add_(0, rows, vals.abs())
        lvl.l1inv = torch.where(l1 == 0, 0.0, 1.0 / torch.where(
            l1 == 0, 1.0, l1))
    if relax & {13, 14}:
        shape = (n, n)
        lo, up = rows >= cols, rows <= cols
        lvl.lower = _csr(rows[lo], cols[lo], vals[lo], shape)
        lvl.upper = _csr(rows[up], cols[up], vals[up], shape)
        lvl.strict_lower = _csr(rows[~up], cols[~up], vals[~up], shape)
        lvl.strict_upper = _csr(rows[~lo], cols[~lo], vals[~lo], shape)


def transpose(M: torch.Tensor) -> torch.Tensor:
    """The transpose of a CSR tensor, as CSR."""
    rows, cols, vals = _coo(M)
    return _csr(cols, rows, vals, (M.shape[1], M.shape[0]))


class Hierarchy:
    """The reference hierarchy over the benchmark's fine matrix A0
    (scipy): make_P(level, A_level) gives each level's interpolation
    (torch CSR, in dtype on device), None below the coarsest."""

    def __init__(self, A0: sp.spmatrix, make_P, relax_down: int,
                 relax_up: int, weight: float = 1.0, *, dtype, device):
        if relax_down not in RELAX or relax_up not in RELAX:
            raise ValueError(f"relax types {relax_down}, {relax_up}: the "
                             f"reference has {RELAX}")
        if weight != 1.0 and {relax_down, relax_up} & {13, 14}:
            raise ValueError("the reference's Gauss-Seidel sweeps are "
                             "unweighted (relax weight 1)")
        self.relax_down, self.relax_up, self.w = relax_down, relax_up, weight
        self.dtype, self.device = dtype, device
        A = to_torch_csr(A0, dtype, device)
        self.levels = []
        while (P := make_P(len(self.levels), A)) is not None:
            PT = transpose(P)
            self.levels.append(Level(A=A, P=P, PT=PT))
            A = galerkin(A, P, PT)
        coarse = Level(A=A)
        coarse.pinv = torch.linalg.pinv(A.to_dense(), rtol=1e-12)
        self.levels.append(coarse)
        for lvl in self.levels[:-1]:
            _smoother_parts(lvl, {relax_down, relax_up})

    def _relax(self, lvl: Level, kind: int, u, f):
        """One sweep; u None is the zero initial guess."""
        if kind == 18:
            if u is None:
                return self.w * lvl.l1inv * f
            return u + self.w * lvl.l1inv * (f - mv(lvl.A, u))
        fwd = kind == 13
        rhs = f if u is None else f - mv(
            lvl.strict_upper if fwd else lvl.strict_lower, u)
        tri = lvl.lower if fwd else lvl.upper
        return torch.triangular_solve(rhs[:, None], tri, upper=not fwd
                                      ).solution[:, 0]

    def cycle(self, f: torch.Tensor) -> torch.Tensor:
        """One V(1, 1) cycle from a zero guess: the preconditioner."""
        return self._cycle(0, f)

    def _cycle(self, l: int, f: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[l]
        if lvl.pinv is not None:
            return mv(lvl.pinv, f)
        u = self._relax(lvl, self.relax_down, None, f)
        e = self._cycle(l + 1, mv(lvl.PT, f - mv(lvl.A, u)))
        u = u + mv(lvl.P, e)
        return self._relax(lvl, self.relax_up, u, f)

    def operators(self) -> list:
        """A_l of every level, finest first."""
        return [lvl.A for lvl in self.levels]
