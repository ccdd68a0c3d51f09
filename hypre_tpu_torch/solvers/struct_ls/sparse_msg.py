"""SparseMSG: multigrid with multiple semicoarsened grids (port of
hypre_tpu/solvers/struct_ls/sparse_msg.py).

Reference: struct_ls/sparse_msg{,_setup,_solve}.c (Mulder's MSG scheme,
sparse variant).  Grids are indexed (lx, ly, lz) by how many times each
direction has been semicoarsened (sparse_msg.h:94 MapIndex); the cycle
sweeps grid LEVELS l = lx+ly+lz downward, restricting each grid's
residual to ALL of its children (one per direction) with
multiply-visited children averaged by restrict_count
(sparse_msg_solve.c:196-293), then interpolates corrections back up the
same DAG (again averaged over incoming edges).  Robust for anisotropy
without committing to PFMG's single coarsening direction per level.

Each grid's operator is a StructMatrix (the stencil matvec on the
device); per-direction P is the PFMG stencil-collapse interpolation;
Galerkin coarse operators and transfers are host scipy (setup runs
once).  The transfers P and R = P^T are frozen through
`ops/dia.py::freeze_auto` and applied by its `spmv`: on the card the
non-square ones run the ELL kernel (`kernel_launches` counts them),
those of at most `DENSE_MAX_ROWS` rows and columns a dense product.

On a sharded grid (parallel/par_struct.py::shard_solver; the setup
stays serial) each grid's operator, inverse diagonal and visit weights
are cut to its layout (the fine layout projected along each direction
the grid was coarsened), each transfer a `par_struct.ShardedTransfer`
(a ParCSR: the halo exchange and one ELL launch a shard).  The ELL sums a row's entries in the merged
diag-then-offd order, so the sharded cycle agrees with the serial one
to rounding, not bitwise.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, kernel_launches, spmv, sum_launches
from ...struct.matrix import StructMatrix, struct_matvec
from ...utils.timing import timed
from ..krylov.common import SolverResult, tdot, tfirst, tmap, tsub, tzeros_like
from .jacobi import inverse_diagonal
from .pfmg import _build_P, _collapse_interp


@dataclasses.dataclass
class SparseMSGOptions:
    tol: float = 1e-6
    max_iter: int = 100
    relax_weight: float = 0.8
    num_pre: int = 1
    num_post: int = 1


def _norm(v) -> float:
    """||v||: of a grid tensor, or of a sharded vector (the square root
    of the shards' dots added in shard order)."""
    if isinstance(v, torch.Tensor):
        return float(torch.linalg.vector_norm(v.reshape(-1)))
    return float(torch.sqrt(tdot(v, v)))


def _transfer(T, v, shape):
    """T v: a frozen operator on a grid tensor, or a sharded transfer
    on a sharded vector."""
    if isinstance(v, torch.Tensor):
        return spmv(T, v.reshape(-1)).reshape(shape)
    return T.matvec(v)


class SparseMSG:
    layout = None  # a StructLayout once sharded (par_struct.shard_solver)

    def __init__(self, A: StructMatrix,
                 opts: SparseMSGOptions = SparseMSGOptions(), *, device=None):
        """`device`: where the grids and transfers live and the cycle runs
        (None: A's device); the setup runs on the host."""
        self.opts = opts
        self.device = torch.device(A.device if device is None else device)
        with timed("STRUCT_SETUP", self.device):
            self._setup(A.densify().to("cpu"))

    def _edge(self, g, d, step=1):
        return tuple(v + (step if i == d else 0) for i, v in enumerate(g))

    def _setup(self, A0: StructMatrix) -> None:
        dev = self.device
        shape0 = tuple(A0.shape)
        nd = len(shape0)
        nl = []
        for d in range(nd):
            s, k = shape0[d], 1
            while s > 2:
                k += 1
                s = (s + 1) // 2
            nl.append(k)
        self.nl = tuple(nl)
        self.root = (0,) * nd

        grids = {self.root: A0}
        self.Pmat = {}  # (grid, dir) -> (scipy P, coarse shape)
        for level in range(1, sum(self.nl) - nd + 1):
            for g in itertools.product(*[range(k) for k in self.nl]):
                if sum(g) != level or g in grids:
                    continue
                d = next(i for i in range(nd) if g[i] > 0)
                parent = self._edge(g, d, -1)
                if parent not in grids:
                    continue
                Ap = grids[parent]
                if Ap.shape[d] < 3:
                    continue
                with timed("STRUCT_INTERP"):
                    p_lo, p_hi = _collapse_interp(Ap, d)
                    P, cshape = _build_P(tuple(Ap.shape), d, p_lo, p_hi)
                with timed("STRUCT_RAP"):
                    Ac = (P.T @ Ap.to_scipy() @ P).tocsr()
                    grids[g] = StructMatrix.from_scipy(Ac, cshape, device="cpu")
                self.Pmat[(parent, d)] = (P, cshape)
        # fill remaining DAG edges (multiple parents per grid)
        for g, Ag in list(grids.items()):
            for d in range(nd):
                child = self._edge(g, d)
                if child in grids and (g, d) not in self.Pmat and Ag.shape[d] >= 3:
                    with timed("STRUCT_INTERP"):
                        p_lo, p_hi = _collapse_interp(Ag, d)
                        P, cshape = _build_P(tuple(Ag.shape), d, p_lo, p_hi)
                    if cshape == tuple(grids[child].shape):
                        self.Pmat[(g, d)] = (P, cshape)
        self.keys = sorted(grids, key=lambda g: (sum(g), g))
        with timed("STRUCT_FREEZE", dev):
            self._freeze(grids)

    def _freeze(self, grids: dict) -> None:
        """The transfers, visit weights, inverse diagonals and operators
        on the device."""
        dev = self.device
        nd = len(self.root)
        # device transfer operators, frozen as the JAX package freezes them
        self.Pdev = {}
        self.Rdev = {}
        self.cshapes = {}
        for (g, d), (P, cshape) in self.Pmat.items():
            self.Pdev[(g, d)] = freeze_auto(CSRMatrix.from_scipy(P.tocsr()),
                                            torch.float64, dev)
            self.Rdev[(g, d)] = freeze_auto(CSRMatrix.from_scipy(P.T.tocsr()),
                                            torch.float64, dev)
            self.cshapes[(g, d)] = cshape
        # visit weights (sparse_msg_filter.c FilterSetup): per point,
        # lambda_d = (sum of +a over offsets with zero d-component,
        # -a otherwise)^2; visit_d = lambda_d / sum(lambda) partitions
        # the interpolated corrections among directions
        self.visit = {}
        for g in self.keys:
            Ag = grids[g]
            data = Ag.data.numpy()
            lam = []
            for d in range(nd):
                acc = np.zeros(Ag.shape)
                for k, off in enumerate(Ag.offsets):
                    acc += data[k] if off[d] == 0 else -data[k]
                lam.append(acc**2)
            tot = sum(lam)
            tot = np.where(tot == 0, 1.0, tot)
            self.visit[g] = tuple(torch.from_numpy(l / tot).to(dev) for l in lam)
        self.dinv = {g: inverse_diagonal(grids[g], dev) for g in self.keys}
        self.grids = {g: A.boxed().to(dev) for g, A in grids.items()}

    def _relax(self, g, u, f, sweeps):
        A = self.grids[g]
        w = self.opts.relax_weight
        for _ in range(sweeps):
            u = tmap(lambda uu, d, rr: uu + w * d.reshape(uu.shape) * rr,
                     u, self.dinv[g], tsub(f, struct_matvec(A, u)))
        return u

    def cycle(self, f0, u0=None):
        o = self.opts
        if u0 is None:
            u0 = tzeros_like(f0)
        F = {self.root: f0}
        U = {self.root: u0}
        count = {self.root: 1}
        max_level = max(sum(g) for g in self.keys)
        for level in range(max_level + 1):
            for g in [k for k in self.keys if sum(k) == level and k in F]:
                if count[g] > 1:
                    F[g] = tmap(lambda v, c=count[g]: v / c, F[g])
                U[g] = self._relax(g, U[g], F[g], o.num_pre)
                r = tsub(F[g], struct_matvec(self.grids[g], U[g]))
                for d in range(len(g)):
                    key = (g, d)
                    child = self._edge(g, d)
                    if key not in self.Pmat or child not in self.grids:
                        continue
                    rc = _transfer(self.Rdev[key], r, self.cshapes[key])
                    if child in F:
                        F[child] = tmap(torch.add, F[child], rc)
                        count[child] += 1
                    else:
                        F[child] = rc
                        U[child] = tzeros_like(rc)
                        count[child] = 1
        for level in range(max_level, 0, -1):
            for g in [k for k in self.keys if sum(k) == level and k in U]:
                U[g] = self._relax(g, U[g], F[g], o.num_post)
                for d in range(len(g)):
                    p = self._edge(g, d, -1)
                    if p not in U or (p, d) not in self.Pmat:
                        continue
                    pshape = tuple(self.grids[p].shape)
                    up = _transfer(self.Pdev[(p, d)], U[g], pshape)
                    U[p] = tmap(lambda uu, v, e: uu + v * e, U[p],
                                self.visit[p][d], up)
        return self._relax(self.root, U[self.root], F[self.root], o.num_post)

    def cycle_launches(self) -> dict:
        """{kernel name: launches} of one `cycle` on CUDA vectors: each
        transfer that the cycle applies once (every frozen R on the way
        down, every P on the way up); sharded, one ELL launch a shard a
        transfer."""
        return sum_launches([(T.kernel_launches() if self.layout is not None
                              else kernel_launches(T), 1) for T in
                             (*self.Rdev.values(), *self.Pdev.values())])

    def solve(self, b, x0=None) -> SolverResult:
        """Cycles from x0 until ||b - A x|| / ||b|| < tol: one host read an
        iteration, the residual norm."""
        o = self.opts
        A = self.grids[self.root]
        x = tzeros_like(b) if x0 is None else x0
        bnorm = _norm(b) or 1.0
        norms = [_norm(tsub(b, struct_matvec(A, x)))]
        it = 0
        while it < o.max_iter:
            x = self.cycle(b, x)
            it += 1
            rn = _norm(tsub(b, struct_matvec(A, x)))
            norms.append(rn)
            if rn / bnorm < o.tol:
                break
        b0 = tfirst(b)
        return SolverResult(
            x=x,
            num_iterations=it,
            rel_residual_norm=torch.tensor(norms[-1] / bnorm, dtype=b0.dtype,
                                           device=b0.device),
            converged=norms[-1] / bnorm < o.tol,
            res_norms=torch.tensor(norms, dtype=b0.dtype, device=b0.device),
        )
