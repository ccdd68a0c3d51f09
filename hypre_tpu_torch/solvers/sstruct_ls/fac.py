"""FAC: fast adaptive composite multigrid for structured AMR (port of
hypre_tpu/solvers/sstruct_ls/fac.py).

Reference: sstruct_ls/fac*.c (17 files, ~12 kLoC): composite grids of
nested refinement patches; hypre assembles the composite operator
(fac_amr_rap.c + fac_cf{stencil,coarsen}.c: coarse rows near the
interface couple to fine patch cells, overlapped coarse data zeroed by
fac_zero_cdata.c), then cycles level by level: relax on each refinement
level, coarse-grid-correct below, interpolate back (fac_interp2.c).

`build_composite_amr` assembles the composite operator for any nested
patch chain (the fac_amr_rap/fac_zero_cdata roles: overlapped coarse
cells are removed from the unknown set, CF interfaces carry first-order
flux-matched stencils), on the host, the JAX package's arithmetic; users
with their own AMR discretization hand `FAC` a composite matrix plus the
level index ranges directly.  The cycle is multiplicative across levels
— patch-block corrections sweep finest->coarsest->finest, each block
solved by an inner BoomerAMG (the role of hypre recursing SysPFMG per
level) — the standard multiplicative-FAC formulation.  The composite
operator is frozen by `freeze_auto` and the block BoomerAMGs built on
`device`, where the cycle runs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, spmv
from ..krylov.common import SolverResult


@dataclasses.dataclass
class FACOptions:
    tol: float = 1e-6
    max_iter: int = 60
    num_pre: int = 2
    num_post: int = 2
    relax_weight: float = 0.8


def build_composite_amr(cshape, patches, h0=1.0):
    """Composite 7-pt Poisson operator over an AMR hierarchy.

    cshape: coarsest grid (level 0) cell counts.
    patches: nested [(origin, size, factor), ...] — patch l+1 covers
      `size` LEVEL-l cells starting at `origin` (level-l index space),
      refined by `factor` per axis.  Unknowns = each level's cells NOT
      covered by the next patch (fac_zero_cdata.c: overlapped coarse
      data carries no dofs), numbered level 0 first.
    CF interfaces (fac_cfstencil.c role, lowest order): a coarse cell
    abutting a patch couples to the mean of the facing fine cells; a
    fine boundary cell couples to the facing parent cell across the
    center distance h_l (1 + f) / 2.

    Returns (A csr, level_ranges, level_index_maps) where
    level_ranges[l] = (start, end) and level_index_maps[l] maps level-l
    cell -> unknown id (-1 where covered).
    """
    L = len(patches) + 1
    shapes = [tuple(int(s) for s in cshape)]
    hs = [float(h0)]
    for (orig, size, f) in patches:
        shapes.append(tuple(int(s * f) for s in size))
        hs.append(hs[-1] / f)

    dim = len(shapes[0])
    covered = []
    for l in range(L - 1):
        orig, size, f = patches[l]
        cov = np.zeros(shapes[l], bool)
        cov[tuple(slice(o, o + s) for o, s in zip(orig, size))] = True
        covered.append(cov)
    covered.append(np.zeros(shapes[-1], bool))

    idx_maps = []
    ranges = []
    start = 0
    for l in range(L):
        m = -np.ones(shapes[l], np.int64)
        act = np.flatnonzero(~covered[l].ravel())
        m.ravel()[act] = start + np.arange(len(act))
        idx_maps.append(m)
        ranges.append((start, start + len(act)))
        start += len(act)
    n = start

    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(int(r))
        cols.append(int(c))
        vals.append(float(v))

    for l in range(L):
        shape = shapes[l]
        h = hs[l]
        w_in = 1.0 / h**2
        fdown = patches[l][2] if l < L - 1 else 1
        o_down = patches[l][0] if l < L - 1 else None
        fup = patches[l - 1][2] if l > 0 else 1
        o_up = patches[l - 1][0] if l > 0 else None
        for I in np.ndindex(shape):
            if covered[l][I]:
                continue
            r = idx_maps[l][I]
            diag = 0.0
            for d in range(dim):
                for s_ in (-1, 1):
                    J = list(I)
                    J[d] += s_
                    if 0 <= J[d] < shape[d]:
                        J = tuple(J)
                        if not covered[l][J]:
                            add(r, idx_maps[l][J], -w_in)
                            diag += w_in
                        else:
                            # flux into the patch: mean of facing fine
                            # cells of level l+1 (fac_cfstencil.c)
                            face = []
                            base = [fdown * (J[k] - o_down[k]) for k in range(dim)]
                            # the fine layer of J nearest to I
                            base[d] = (
                                fdown * (J[d] - o_down[d])
                                if s_ > 0 else
                                fdown * (J[d] - o_down[d]) + fdown - 1
                            )
                            od = [k for k in range(dim) if k != d]
                            for off in np.ndindex(*(fdown,) * (dim - 1)):
                                F = list(base)
                                for t, k in enumerate(od):
                                    F[k] = base[k] + off[t]
                                face.append(tuple(F))
                            w = w_in / len(face)
                            for F in face:
                                add(r, idx_maps[l + 1][F], -w)
                            diag += w_in
                    else:
                        if l == 0:
                            diag += w_in  # Dirichlet domain boundary
                            continue
                        # CF interface to the parent level
                        Jp = [o_up[k] + I[k] // fup for k in range(dim)]
                        Jp[d] += s_
                        if all(0 <= Jp[k] < shapes[l - 1][k] for k in range(dim)) \
                                and not covered[l - 1][tuple(Jp)]:
                            # center distance h_l (1 + f) / 2
                            w = 1.0 / (h * h * (1 + fup) / 2.0)
                            add(r, idx_maps[l - 1][tuple(Jp)], -w)
                            diag += w
                        else:
                            diag += w_in  # Dirichlet
            add(r, r, diag)

    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    A.sort_indices()
    return A, ranges, idx_maps


def build_composite_poisson(cshape, origin, psize, h_c=1.0):
    """The 2-level composite: one factor-2 patch.
    Returns (A, cidx, fidx, nc)."""
    A, ranges, maps = build_composite_amr(
        cshape, [(tuple(origin), tuple(psize), 2)], h0=h_c
    )
    nc = ranges[0][1]
    return A, maps[0], maps[1], nc


class FAC:
    """Multiplicative FAC on an assembled composite operator: per cycle,
    block corrections sweep finest -> coarsest -> finest, each level
    block solved by an inner BoomerAMG (the role of hypre recursing a
    struct solver per refinement level; the blocks here are general CSR
    because interface rows break the constant stencil).  Standalone
    cycles converge for 2-level hierarchies; deeper chains (the strongly
    nonsymmetric multi-interface composites) are used as a GMRES
    preconditioner — matching how the reference deploys FAC inside
    Krylov wrappers.  `FAC(A, nc)` takes a 2-level split at nc; any
    composite CSR takes its level ranges.
    """

    def __init__(self, A_comp: sp.csr_matrix, ranges,
                 opts: FACOptions = FACOptions(), *, device="cuda"):
        from ..amg import BoomerAMG, BoomerAMGOptions

        self.opts = opts
        self.device = dev = torch.device(device)
        self.n = A_comp.shape[0]
        if isinstance(ranges, (int, np.integer)):  # 2-level (A, nc) form
            ranges = [(0, int(ranges)), (int(ranges), self.n)]
        self.ranges = [tuple(map(int, rg)) for rg in ranges]
        self.A = CSRMatrix.from_scipy(A_comp.tocsr())
        self.Asp = A_comp.tocsr()
        amg_opts = BoomerAMGOptions(
            coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
            relax_down=18, relax_up=18, embed_level1=False,
        )
        self.block_amg = []
        for lo, hi in self.ranges:
            Ab = A_comp[lo:hi, lo:hi].tocsr()
            self.block_amg.append(
                BoomerAMG(CSRMatrix.from_scipy(Ab), amg_opts, device=dev)
            )
        self._E = freeze_auto(self.A, torch.float64, dev)

    def _residual(self, u, b):
        return b - spmv(self._E, u)

    def _block_correct(self, u, b, l, iters):
        """u with level l's block corrected: a new tensor (the caller's u
        is left as it is)."""
        lo, hi = self.ranges[l]
        r = self._residual(u, b)
        e = self.block_amg[l].solve(r[lo:hi], tol=1e-6, max_iter=iters).x
        u = u.clone()
        u[lo:hi] += e
        return u

    def cycle(self, b, u):
        o = self.opts
        L = len(self.ranges)
        # down sweep: finest patch first (fac cycle order), coarsest last
        for l in range(L - 1, 0, -1):
            u = self._block_correct(u, b, l, o.num_pre + 4)
        u = self._block_correct(u, b, 0, 20)
        # up sweep: re-correct the patches against the updated levels
        for l in range(1, L):
            u = self._block_correct(u, b, l, o.num_post + 4)
        return u

    def solve(self, b) -> SolverResult:
        """Cycles from zero until ||b - A u|| / ||b|| < tol: one host
        read a cycle."""
        o = self.opts
        u = torch.zeros_like(b)
        bn = float(torch.linalg.vector_norm(b)) or 1.0
        norms = []
        it = 0
        while it < o.max_iter:
            u = self.cycle(b, u)
            it += 1
            rn = float(torch.linalg.vector_norm(self._residual(u, b)))
            norms.append(rn)
            if rn / bn < o.tol:
                break
        return SolverResult(
            x=u,
            num_iterations=it,
            rel_residual_norm=torch.tensor(norms[-1] / bn, dtype=b.dtype,
                                           device=b.device),
            converged=norms[-1] / bn < o.tol,
            res_norms=torch.tensor(norms, dtype=b.dtype, device=b.device),
        )
