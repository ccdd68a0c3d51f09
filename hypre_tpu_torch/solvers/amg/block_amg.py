"""Block-CSR systems AMG — the parcsr_block_mv role (port of
hypre_tpu/solvers/amg/block_amg.py).

Reference: parcsr_block_mv/ (16.3 kLoC: par_csr_block_matrix.c block
storage, block matvec/RAP/interp/relax + par_nodal_systems.c beyond
coarsening).  The whole hierarchy is block-valued: every matrix entry
is an nb x nb dense block (nb = num_functions), smoothing inverts nodal
blocks, interpolation weights are block matrices, and the Galerkin
product runs in block arithmetic.

Host container = scipy BSR (its matmul IS the block RAP); the setup is
the JAX package's host code, line for line (nodal strength + PMIS, the
block direct and block classical interpolations as node loops).  Device
format = block-ELL: cols [nbrow_pad, w] int32 + data [nbrow_pad, w, nb,
nb] on `device`; the matvec gathers the neighbour blocks with
`index_select` and contracts them with `torch.einsum`, plain torch as
the JAX package's is plain jnp.  Block-Jacobi smoothing applies the
batched nb x nb diagonal inverses the same way.  Coarsening reuses the
nodal-strength + PMIS machinery (one CF decision per node);
interpolation is the block classical/direct family:
  direct:    W_ij = -inv(A_ii) A_ij * s_i  (row-sum matched, blockwise)
where s_i rescales so row sums of [W, I] match the fine block row
(par_csr_block_matrix.c block direct-interp analog).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, torch_dtype
from ...utils.errors import arg_error
from ..krylov.common import SolverResult
from .coarsen import pmis_coarsen
from .strength import create_nodal_A, strength_matrix, strength_matrix_abs


@dataclasses.dataclass(frozen=True)
class BlockELL:
    """Device block-ELL: data[r, k] is the nb x nb block coupling block
    row r to block col cols[r, k] (padding: col 0, zero block)."""

    cols: torch.Tensor  # int32 [nbrow_pad, width]
    data: torch.Tensor  # [nbrow_pad, width, nb, nb]
    num_brows: int
    num_bcols: int

    @property
    def nb(self) -> int:
        return self.data.shape[-1]


def bsr_to_block_ell(A: sp.bsr_matrix, dtype=None, *, device="cuda") -> BlockELL:
    A = A.tobsr()
    A.sort_indices()
    nb = A.blocksize[0]
    nbrow = A.shape[0] // nb
    nbcol = A.shape[1] // nb
    rn = np.diff(A.indptr)
    width = max(int(rn.max(initial=0)), 1)
    nbrow_pad = ((nbrow + 7) // 8) * 8
    cols = np.zeros((nbrow_pad, width), dtype=np.int32)
    data = np.zeros((nbrow_pad, width, nb, nb), dtype=dtype or A.data.dtype)
    if A.indptr[-1]:
        r = np.repeat(np.arange(nbrow), rn)
        k = np.arange(A.indptr[-1]) - np.repeat(A.indptr[:-1], rn)
        cols[r, k] = A.indices
        data[r, k] = A.data
    dev = torch.device(device)
    return BlockELL(
        cols=torch.from_numpy(cols).to(dev), data=torch.from_numpy(data).to(dev),
        num_brows=nbrow, num_bcols=nbcol,
    )


def block_spmv(A: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with x [nbcol, nb] block layout -> [nbrow_pad, nb]."""
    w = A.cols.shape[1]
    xg = x.index_select(0, A.cols.reshape(-1)).reshape(-1, w, x.shape[-1])
    return torch.einsum("rwij,rwj->ri", A.data, xg)


def _node_interleave(x_flat: torch.Tensor, nb: int) -> torch.Tensor:
    return x_flat.reshape(-1, nb)


@dataclasses.dataclass
class _BLevel:
    A: BlockELL
    Ah: sp.bsr_matrix
    dinv: torch.Tensor  # [nbrow_pad, nb, nb] block-diagonal inverses
    P: Optional[BlockELL]
    R: Optional[BlockELL]
    coarse_inv: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BlockAMGOptions:
    num_functions: int = 2
    strong_threshold: float = 0.25
    max_row_sum: float = 0.9
    nodal: int = 1  # nodal norm type for the strength matrix (par_nodal_systems.c)
    max_levels: int = 25
    max_coarse_nodes: int = 16
    relax_weight: float = 0.8  # block-Jacobi damping
    num_sweeps: int = 1
    trunc_max_elmts: int = 4
    seed: int = 2747
    dtype: str = "float64"
    # block interpolation family (ij.c help: 10 = classical block
    # interpolation, 11 = classical block w/ diagonal blocks only,
    # 23 here spelled by name): "direct" (BuildBlockDirInterp) |
    # "classical" (par_csr_block_interp.c:27 BuildBlockInterp) |
    # "classical_diag" (BuildBlockInterpDiag:1660 — F-distribution and
    # diagonal inverses use only the DIAGONAL entries of each block)
    interp_type: str = "direct"


class BlockAMG:
    """Systems AMG with an nb x nb block hierarchy (nodal unknowns
    interleaved: dof = node * nb + fn), frozen on `device`."""

    def __init__(self, A: CSRMatrix, opts: BlockAMGOptions = BlockAMGOptions(),
                 *, device="cuda"):
        self.opts = opts
        self.device = torch.device(device)
        nb = opts.num_functions
        As = A.to_scipy().tocsr()
        if As.shape[0] % nb:
            raise arg_error("matrix size not divisible by num_functions")
        self.levels: list[_BLevel] = []
        self._setup(As.tobsr(blocksize=(nb, nb)))

    # ------------------------------------------------------------------
    def _setup(self, A: sp.bsr_matrix):
        o = self.opts
        nb = o.num_functions
        dt = np.dtype(o.dtype)
        while True:
            nnode = A.shape[0] // nb
            last = (
                nnode <= o.max_coarse_nodes
                or len(self.levels) >= o.max_levels - 1
            )
            cf = None
            P = None
            if not last:
                # nodal strength on the scalar view (par_nodal_systems.c)
                Acsr = A.tocsr()
                AN = create_nodal_A(Acsr, nb, o.nodal, 0)
                if o.nodal in (3, 6):
                    SN = strength_matrix(
                        CSRMatrix.from_scipy(AN), o.strong_threshold,
                        o.max_row_sum,
                    )
                else:
                    SN = strength_matrix_abs(AN, o.strong_threshold, o.max_row_sum)
                cf = pmis_coarsen(SN, seed=o.seed)
                nc = int((cf > 0).sum())
                if nc == 0 or nc == nnode:
                    last = True
                elif o.interp_type == "direct":
                    P = self._block_direct_interp(A, SN, cf)
                else:
                    P = self._block_classical_interp(
                        A, SN, cf, diag_only=o.interp_type == "classical_diag"
                    )
            self.levels.append(self._freeze(A, P, cf, dt))
            if last:
                break
            R = _bsr_T(P)
            A = (R @ (A @ P)).tobsr(blocksize=(nb, nb))

    @staticmethod
    def _block_classical_interp(A: sp.bsr_matrix, SN: sp.csr_matrix, cf,
                                diag_only: bool = False):
        """Block classical interpolation (par_csr_block_interp.c:27
        hypre_BoomerAMGBuildBlockInterp, serial semantics):

        For F node i with strong-C set C_i and diagonal block D = A_ii:
          * strong C neighbor j:  W_ij += A_ij
          * strong F neighbor k:  sum = SUM_{j in C_i} A_kj; if sum is
            invertible, distribute = A_ik * sum^{-1} (that operand
            order — the reference notes it matters for non-symmetric
            blocks) and W_ij += distribute * A_kj for j in C_i; if
            singular, D += A_ik (lumped, add_weak_to_diag=1 default)
          * weak neighbor k (not SF): D += A_ik
        finally W_ij <- -D^{-1} W_ij; C rows get identity blocks.

        diag_only (BuildBlockInterpDiag:1660): every block above is
        first masked to its diagonal (off-diagonal entries of each
        nb x nb block ignored), decoupling the functions."""
        nb = A.blocksize[0]
        nnode = A.shape[0] // nb
        Ab = A.tobsr()
        Ab.sort_indices()
        indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
        if diag_only:
            data = np.where(np.eye(nb, dtype=bool)[None, :, :], Ab.data, 0.0)
        cmap = -np.ones(nnode, dtype=np.int64)
        cmap[cf > 0] = np.arange(int((cf > 0).sum()))
        strong_of = [
            set(SN.indices[SN.indptr[i]: SN.indptr[i + 1]])
            for i in range(nnode)
        ]
        # block row lookup: node -> {col: block}
        rows_l, cols_l, blocks_l = [], [], []
        eye = np.eye(nb)
        for i in range(nnode):
            if cf[i] > 0:
                rows_l.append(i)
                cols_l.append(cmap[i])
                blocks_l.append(eye)
                continue
            s, e = indptr[i], indptr[i + 1]
            cset = {}
            D = None
            strong = strong_of[i]
            # pass 1: columns + diagonal
            for p in range(s, e):
                j = indices[p]
                if j == i:
                    D = data[p].copy()
                elif j in strong and cf[j] > 0:
                    cset[j] = np.zeros((nb, nb))
            if D is None or not cset:
                continue  # isolated F node
            for p in range(s, e):
                j = indices[p]
                if j == i:
                    continue
                blk = data[p]
                if j in cset:
                    cset[j] += blk
                elif j in strong and cf[j] <= 0 and cf[j] != -3:
                    # strong F: distribute through row j's C_i entries
                    sj, ej = indptr[j], indptr[j + 1]
                    cols_j = indices[sj:ej]
                    summ = np.zeros((nb, nb))
                    hits = []
                    for q in range(sj, ej):
                        j2 = cols_j[q - sj]
                        if j2 in cset:
                            summ += data[q]
                            hits.append((j2, q))
                    ok = hits and np.linalg.cond(summ) < 1e12
                    if ok:
                        distribute = blk @ np.linalg.inv(summ)
                        for j2, q in hits:
                            cset[j2] += distribute @ data[q]
                    else:
                        D += blk
                elif cf[j] != -3:
                    D += blk  # weak, lump to diagonal
            Dinv = np.linalg.pinv(D)
            for j, W in cset.items():
                rows_l.append(i)
                cols_l.append(cmap[j])
                blocks_l.append(-Dinv @ W)
        nc = int((cf > 0).sum())
        return _bsr_from_blocks(
            np.asarray(rows_l), np.asarray(cols_l), np.asarray(blocks_l),
            nnode, nc, nb,
        )

    @staticmethod
    def _block_direct_interp(A: sp.bsr_matrix, SN: sp.csr_matrix, cf):
        """Block direct interpolation (block analog of par_interp.c
        hypre_BoomerAMGBuildDirInterp):
          W_ij = -inv(A_ii) A_ij S_i  for j in C_i (strong C neighbors),
        with S_i chosen so the row sums match:
          S_i = [sum_{j in C_i} block]^{-1} [sum_{all j != i} block].
        """
        nb = A.blocksize[0]
        nnode = A.shape[0] // nb
        Ab = A.tobsr()
        Ab.sort_indices()
        indptr, indices, data = Ab.indptr, Ab.indices, Ab.data
        cmap = -np.ones(nnode, dtype=np.int64)
        cmap[cf > 0] = np.arange(int((cf > 0).sum()))

        rows_l, cols_l, blocks_l = [], [], []
        eye = np.eye(nb)
        for i in range(nnode):
            if cf[i] > 0:
                rows_l.append(i)
                cols_l.append(cmap[i])
                blocks_l.append(eye)
                continue
            s, e = indptr[i], indptr[i + 1]
            cols_i = indices[s:e]
            strong = set(SN.indices[SN.indptr[i]: SN.indptr[i + 1]])
            diag = None
            sum_all = np.zeros((nb, nb))
            sum_c = np.zeros((nb, nb))
            picks = []
            for p in range(s, e):
                j = cols_i[p - s]
                if j == i:
                    diag = data[p]
                    continue
                sum_all += data[p]
                if j in strong and cf[j] > 0:
                    sum_c += data[p]
                    picks.append((j, p))
            if not picks or diag is None:
                continue  # isolated F node: zero row (coarse misses it)
            try:
                scale = np.linalg.solve(sum_c, sum_all)
            except np.linalg.LinAlgError:
                scale = np.eye(nb)
            dinv = np.linalg.pinv(diag)
            for j, p in picks:
                rows_l.append(i)
                cols_l.append(cmap[j])
                blocks_l.append(-dinv @ data[p] @ scale)
        nc = int((cf > 0).sum())
        return _bsr_from_blocks(
            np.asarray(rows_l), np.asarray(cols_l), np.asarray(blocks_l),
            nnode, nc, nb,
        )

    def _freeze(self, A: sp.bsr_matrix, P, cf, dt) -> _BLevel:
        o = self.opts
        nb = o.num_functions
        dev = self.device
        nnode = A.shape[0] // nb
        coarsest = P is None
        # block diagonal inverses (from the BSR structure directly)
        Ab = A.tobsr()
        Ab.sort_indices()
        dblocks = np.zeros((((nnode + 7) // 8) * 8, nb, nb))
        for i in range(nnode):
            for p in range(Ab.indptr[i], Ab.indptr[i + 1]):
                if Ab.indices[p] == i:
                    dblocks[i] = Ab.data[p]
                    break
        dinv = np.linalg.pinv(dblocks[:nnode])
        dpad = np.zeros_like(dblocks)
        dpad[:nnode] = dinv
        coarse_inv = None
        if coarsest:
            coarse_inv = torch.from_numpy(
                np.linalg.pinv(A.toarray(), rcond=1e-12).astype(dt)).to(dev)
        return _BLevel(
            A=bsr_to_block_ell(A, dtype=dt, device=dev),
            Ah=A,
            dinv=torch.from_numpy(dpad.astype(dt)).to(dev),
            P=None if P is None else bsr_to_block_ell(P, dtype=dt, device=dev),
            R=None if P is None else bsr_to_block_ell(_bsr_T(P), dtype=dt,
                                                      device=dev),
            coarse_inv=coarse_inv,
        )

    # ------------------------------------------------------------------
    def _smooth(self, lvl: _BLevel, u, f):
        """Damped block-Jacobi (parcsr_block_mv relax analog): each node
        applies its nb x nb diagonal inverse, batched."""
        o = self.opts
        r = f - block_spmv(lvl.A, u)[: f.shape[0]]
        upd = torch.einsum("rij,rj->ri", lvl.dinv[: f.shape[0]], r)
        return u + o.relax_weight * upd

    def _vcycle(self, l, u, f):
        o = self.opts
        lvl = self.levels[l]
        nb = o.num_functions
        if l == len(self.levels) - 1:
            x = (lvl.coarse_inv @ f.reshape(-1)).reshape(-1, nb)
            return x
        for _ in range(o.num_sweeps):
            u = self._smooth(lvl, u, f)
        r = f - block_spmv(lvl.A, u)[: f.shape[0]]
        fc = block_spmv(lvl.R, r)[: self.levels[l + 1].A.num_brows]
        uc = self._vcycle(l + 1, torch.zeros_like(fc), fc)
        u = u + block_spmv(lvl.P, uc)[: f.shape[0]]
        for _ in range(o.num_sweeps):
            u = self._smooth(lvl, u, f)
        return u

    def cycle(self, f_flat, u=None):
        nb = self.opts.num_functions
        f = f_flat.reshape(-1, nb)
        u = torch.zeros_like(f) if u is None else u.reshape(-1, nb)
        return self._vcycle(0, u, f).reshape(-1)

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    def solve(self, b, tol=1e-8, max_iter=100) -> SolverResult:
        """Stationary V-cycles from zero until ||b - A x|| / ||b|| < tol;
        the stop test is read on the host once an iteration."""
        nb = self.opts.num_functions
        A0 = self.levels[0].A
        x = torch.zeros_like(b)
        bn = float(torch.sqrt(torch.dot(b, b)))
        norms = []
        it = 0
        converged = False
        for it in range(max_iter):
            x = self.cycle(b, u=x)
            r = b - block_spmv(A0, x.reshape(-1, nb)).reshape(-1)[: b.shape[0]]
            rn = float(torch.sqrt(torch.dot(r, r)))
            norms.append(rn)
            if rn / max(bn, 1e-300) < tol:
                converged = True
                break
        rel = norms[-1] / max(bn, 1e-300)
        return SolverResult(
            x=x, num_iterations=it + 1,
            rel_residual_norm=torch.tensor(rel, dtype=torch.float64),
            converged=converged,
            res_norms=torch.tensor(norms, dtype=torch.float64),
        )


def _bsr_T(P: sp.bsr_matrix) -> sp.bsr_matrix:
    nb = P.blocksize[0]
    return P.T.tobsr(blocksize=(nb, nb))


def _bsr_from_blocks(rows, cols, blocks, nbrow, nbcol, nb) -> sp.bsr_matrix:
    """Block-COO -> BSR (scipy's triplet constructor is scalar-only)."""
    order = np.lexsort((cols, rows))
    rows, cols, blocks = rows[order], cols[order], blocks[order]
    counts = np.bincount(rows, minlength=nbrow)
    indptr = np.zeros(nbrow + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return sp.bsr_matrix(
        (blocks, cols.astype(np.int64), indptr),
        shape=(nbrow * nb, nbcol * nb), blocksize=(nb, nb),
    )
