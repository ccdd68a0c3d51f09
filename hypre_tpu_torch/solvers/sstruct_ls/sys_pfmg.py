"""SysPFMG — PFMG generalized to nvars-variable structured systems (port
of hypre_tpu/solvers/sstruct_ls/sys_pfmg.py).

Reference: sstruct_ls/sys_pfmg*.c (7 files) + node_relax.c: the PFMG
skeleton (dxyz-driven semicoarsening, stencil-collapse interpolation,
Galerkin RAP) applied blockwise over variables, with nodewise block
relaxation (node_relax.c solves the nvars x nvars diagonal block at
every grid point).

Variable blocks as a dict {(vi,vj) -> StructMatrix} over a shared grid.
The setup runs on the host, the JAX package's arithmetic: the dxyz
choice, each variable's collapse weights, the monolithic Galerkin RAP
through scipy (`StructMatrix.from_scipy`) and the nodewise inverses
(`np.linalg.pinv` over the batch of nvars x nvars blocks, rcond 1e-12).
Each level's blocks, inverses and weights then go to the device, where
the cycle runs: node relax is one batched [*, nvars, nvars] product,
the transfers are `semi_restrict` / `semi_interp_add` per variable
(pfmg.py), the restriction / interpolation of semi_restrict.c /
semi_interp.c along the level's cdir.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...struct.grid import StructGrid
from ...struct.matrix import StructMatrix, struct_matvec
from ...utils.timing import timed
from ..krylov.common import SolverResult
from ..struct_ls.pfmg import (REAL_MAX, _build_P, _collapse_interp,
                              _compute_dxyz, semi_interp_add, semi_restrict)


@dataclasses.dataclass(frozen=True)
class SysPFMGOptions:
    tol: float = 1e-6
    max_iter: int = 200
    num_pre_relax: int = 1
    num_post_relax: int = 1
    max_levels: int = 0
    jacobi_weight: float = 0.8  # nodewise block-Jacobi damping


@dataclasses.dataclass
class _Level:
    blocks: dict  # (vi, vj) -> StructMatrix
    nvars: int
    cdir: int
    node_inv: torch.Tensor  # [*grid, nvars, nvars]
    p_lo: Optional[list] = None  # per-var odd-plane weights
    p_hi: Optional[list] = None


def _sys_matvec(blocks, nvars, xs):
    return tuple(
        sum(struct_matvec(blocks[(vi, vj)], xs[vj]) for vj in range(nvars)
            if (vi, vj) in blocks)
        for vi in range(nvars)
    )


class SysPFMG:
    def __init__(self, blocks: dict, grid: StructGrid,
                 opts: SysPFMGOptions = SysPFMGOptions(), *, device=None):
        """`device`: where the levels live and the cycle runs (None: the
        blocks' device); the setup runs on the host."""
        self.opts = opts
        self.nvars = max(v for v, _ in blocks.keys()) + 1
        first = next(iter(blocks.values()))
        self.device = torch.device(first.device if device is None else device)
        self.levels: list[_Level] = []
        with timed("STRUCT_SETUP", self.device):
            self._setup({k: sm.to("cpu") for k, sm in blocks.items()}, grid)

    # ------------------------------------------------------------------
    def _setup(self, blocks, grid):
        o = self.opts
        nvars = self.nvars
        ndim = grid.ndim
        shape = tuple(grid.shape)
        max_levels = 1 + sum(int(np.log2(max(s, 1))) + 2 for s in shape)
        if o.max_levels:
            max_levels = min(max_levels, o.max_levels)

        # dxyz from the sum over variables' diagonal blocks
        dxyz = np.zeros(3)
        cx = np.zeros(3)
        for v in range(nvars):
            dv, _ = _compute_dxyz(blocks[(v, v)])
            cx[:ndim] += 1.0 / np.maximum(dv[:ndim], 1e-300) ** 2
        dxyz[:ndim] = np.sqrt(1.0 / np.maximum(cx[:ndim], 1e-300))
        dxyz[ndim:] = REAL_MAX / 1000

        sizes = list(shape) + [1] * (3 - ndim)
        B = blocks
        for l in range(max_levels):
            min_d = dxyz[0] + dxyz[1] + dxyz[2] + 1
            cdir = -1
            for d in range(ndim):
                if sizes[d] > 1 and dxyz[d] < min_d:
                    min_d = dxyz[d]
                    cdir = d
            if l == max_levels - 1:
                cdir = -1
            node_inv = self._node_inverses(B, tuple(np.array(sizes[:ndim])))
            if cdir == -1:
                self.levels.append(self._freeze(B, -1, node_inv))
                break

            p_los, p_his, Ps = [], [], []
            with timed("STRUCT_INTERP"):
                for v in range(nvars):
                    lo, hi = _collapse_interp(B[(v, v)], cdir)
                    nf = B[(v, v)].shape[cdir]
                    odd = np.arange(1, nf, 2)
                    sl = [slice(None)] * ndim
                    sl[cdir] = odd
                    p_los.append(lo[tuple(sl)])
                    p_his.append(hi[tuple(sl)])
                    P, cshape = _build_P(tuple(B[(v, v)].shape), cdir, lo, hi)
                    Ps.append(P)

            # monolithic Galerkin RAP, then split back into blocks
            with timed("STRUCT_RAP"):
                Pblk = sp.block_diag(Ps).tocsr()
                n1 = int(np.prod(sizes[:ndim]))
                rowsM, colsM, valsM = [], [], []
                for (vi, vj), sm in B.items():
                    Mc = sm.to_scipy().tocoo()
                    rowsM.append(Mc.row + vi * n1)
                    colsM.append(Mc.col + vj * n1)
                    valsM.append(Mc.data)
                M = sp.coo_matrix(
                    (np.concatenate(valsM),
                     (np.concatenate(rowsM), np.concatenate(colsM))),
                    shape=(nvars * n1, nvars * n1),
                ).tocsr()
                Mc2 = (Pblk.T @ M @ Pblk).tocsr()
                nc = int(np.prod(cshape))
                Bc = {}
                for vi in range(nvars):
                    for vj in range(nvars):
                        sub = Mc2[vi * nc : (vi + 1) * nc,
                                  vj * nc : (vj + 1) * nc]
                        if sub.nnz:
                            Bc[(vi, vj)] = StructMatrix.from_scipy(
                                sub.tocsr(), cshape, device="cpu")

            self.levels.append(self._freeze(B, cdir, node_inv, p_los, p_his))
            dxyz[cdir] *= 2
            sizes[cdir] = (sizes[cdir] + 1) // 2
            B = Bc

    @staticmethod
    def _node_inverses(B, shape) -> np.ndarray:
        """The pseudo-inverse of each point's nvars x nvars diagonal
        block, on the host (the JAX package's batched pinv, bitwise)."""
        nvars = max(v for v, _ in B.keys()) + 1
        blk = np.zeros(tuple(shape) + (nvars, nvars))
        for (vi, vj), sm in B.items():
            z = (0,) * len(shape)
            if z in sm.offsets:
                blk[..., vi, vj] = sm.entry(z).cpu().numpy()
        return np.linalg.pinv(blk, rcond=1e-12)

    @timed("STRUCT_FREEZE")
    def _freeze(self, B, cdir, node_inv, p_lo=None, p_hi=None) -> _Level:
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return _Level(
            blocks={k: sm.boxed().to(dev) for k, sm in B.items()},
            nvars=self.nvars,
            cdir=cdir,
            node_inv=put(node_inv),
            p_lo=None if p_lo is None else [put(a) for a in p_lo],
            p_hi=None if p_hi is None else [put(a) for a in p_hi],
        )

    # ------------------------------------------------------------------
    def _relax(self, lvl: _Level, xs, bs, sweeps):
        w = self.opts.jacobi_weight
        for _ in range(sweeps):
            Ax = _sys_matvec(lvl.blocks, lvl.nvars, xs)
            R = torch.stack([bs[v] - Ax[v] for v in range(lvl.nvars)], dim=-1)
            dz = torch.einsum("...ij,...j->...i", lvl.node_inv, R)
            xs = tuple(xs[v] + w * dz[..., v] for v in range(lvl.nvars))
        return xs

    def _restrict(self, lvl: _Level, rs):
        return tuple(semi_restrict(rs[v], lvl.cdir, lvl.p_lo[v], lvl.p_hi[v])
                     for v in range(lvl.nvars))

    def _interp_add(self, lvl: _Level, xs, es):
        """xs + P es per variable, in place: `_vcycle` passes the xs it
        made itself."""
        return tuple(semi_interp_add(xs[v], lvl.cdir, lvl.p_lo[v],
                                     lvl.p_hi[v], es[v])
                     for v in range(lvl.nvars))

    def _vcycle(self, l, bs):
        o = self.opts
        lvl = self.levels[l]
        zeros = tuple(torch.zeros_like(b) for b in bs)
        if l == len(self.levels) - 1:
            return self._relax(lvl, zeros, bs, 2)
        xs = self._relax(lvl, zeros, bs, o.num_pre_relax)
        Ax = _sys_matvec(lvl.blocks, lvl.nvars, xs)
        rs = tuple(bs[v] - Ax[v] for v in range(lvl.nvars))
        es = self._vcycle(l + 1, self._restrict(lvl, rs))
        xs = self._interp_add(lvl, xs, es)
        return self._relax(lvl, xs, bs, o.num_post_relax)

    def cycle(self, bs, xs=None):
        return self._vcycle(0, bs) if xs is None else self._cycle_from(xs, bs)

    def _cycle_from(self, xs, bs):
        Ax = _sys_matvec(self.levels[0].blocks, self.nvars, xs)
        rs = tuple(bs[v] - Ax[v] for v in range(self.nvars))
        dz = self._vcycle(0, rs)
        return tuple(xs[v] + dz[v] for v in range(self.nvars))

    def solve(self, bs, xs=None) -> SolverResult:
        """sys_pfmg_solve.c's loop: the residual norm on the host at the
        top of each iteration (one read), converged once below tol past
        the first."""
        o = self.opts
        xs = tuple(torch.zeros_like(b) for b in bs) if xs is None else xs
        bb = float(sum(torch.dot(b.reshape(-1), b.reshape(-1)) for b in bs))
        rel = float("inf")
        converged = False
        norms = [float("nan")] * (o.max_iter + 1)
        it_done = 0
        for it in range(o.max_iter):
            Ax = _sys_matvec(self.levels[0].blocks, self.nvars, xs)
            rs = [(bs[v] - Ax[v]).reshape(-1) for v in range(self.nvars)]
            rr = float(sum(torch.dot(r, r) for r in rs))
            norms[it] = np.sqrt(rr)
            rel = np.sqrt(rr / max(bb, 1e-300))
            it_done = it
            if rel < o.tol and it > 0:
                converged = True
                break
            xs = self._cycle_from(xs, bs)
            it_done = it + 1
        b0 = bs[0]
        return SolverResult(
            x=xs,
            num_iterations=it_done,
            rel_residual_norm=torch.tensor(rel, dtype=b0.dtype,
                                           device=b0.device),
            converged=converged,
            res_norms=torch.tensor(norms, dtype=b0.dtype, device=b0.device),
        )
