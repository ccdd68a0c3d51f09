"""PFMG — semicoarsening multigrid for structured grids (port of
hypre_tpu/solvers/struct_ls/pfmg.py).

Reference: struct_ls/pfmg_setup.c (hypre_PFMGSetup:63 — dxyz-driven
coarsening-direction choice :215-233, level Jacobi weights 2/(3-alpha),
skip-relax active flags), pfmg_setup_interp.c (stencil-collapse interp:
center = sum of entries with zero cdir-offset, left/right = -sum of
entries with cdir-offset -/+1, weights left/center, right/center),
pfmg_setup_rap*.c (Galerkin RAP; computed here as exact P^T A P via the
host sparse form and folded back to stencil form), pfmg_solve.c (V-cycle
with convergence test at the top of each iteration), pfmg_relax.c /
point_relax.c (weighted Jacobi, relax_type 1 default).

The setup runs on the host (numpy / scipy on a host copy of A, the JAX
package's arithmetic); each level's operator, inverse diagonal and
interpolation weights then go to the device.  The cycle runs there: each
level's residual / relax is a stencil matvec and elementwise ops;
restriction and interpolation are strided-slice adds along the level's
cdir.  `solve` is a host loop with one host read an iteration (the
residual norm), where the JAX package runs a `lax.while_loop`.

On a sharded grid (parallel/par_struct.py::shard_solver) each level's
operator, inverse diagonal, red mask and transfer (`xfer`) are cut to
the level's layout (the fine one projected onto each coarse grid), so
`solve`, `cycle` and `precond` take and return tuples of grid blocks.
Each point's arithmetic is the serial one; only the stop test's dot
sums the shards' dots in shard order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...struct.matrix import StructMatrix, struct_matvec
from ...utils.timing import timed
from ..krylov.common import (SolverResult, tdot, tfirst, tmap, tsub,
                             tzeros_like)
from .relax import parity_mask, red_black_gs

REAL_MAX = 1.7976931348623157e308


@dataclasses.dataclass(frozen=True)
class PFMGOptions:
    tol: float = 1e-6
    max_iter: int = 200
    max_levels: int = 0  # 0 = automatic
    relax_type: int = 1  # 1 = weighted Jacobi (default); 0 = w=1 Jacobi
    jacobi_weight: float = 0.0  # user weight if > 0
    num_pre_relax: int = 1
    num_post_relax: int = 1
    skip_relax: int = 1
    rel_change: bool = False
    zero_guess: bool = True
    dxyz: tuple | None = None  # user-supplied grid spacings


@dataclasses.dataclass
class _Level:
    A: StructMatrix
    dinv: torch.Tensor
    cdir: int  # -1 on coarsest
    active: bool
    weight: float
    p_lo: Optional[torch.Tensor] = None  # interp weights at odd fine points
    p_hi: Optional[torch.Tensor] = None
    red_mask: Optional[torch.Tensor] = None  # parity coloring (relax 2/3)
    xfer: object = None  # the sharded transfer (par_struct.ShardedSemi)


def _host_data(A: StructMatrix) -> np.ndarray:
    return A.data.cpu().numpy()


def _compute_dxyz(A: StructMatrix):
    """hypre_PFMGComputeDxyz: per-dim coupling strengths ->
    dxyz[d] = sqrt(cxyz_max / cxyz[d]); also the variation flag."""
    data = _host_data(A)
    ndim = data.ndim - 1
    acc = A.diagonal().cpu().numpy()
    diag_sign = np.where(acc < 0, -1.0, 1.0)
    n = data[0].size
    cxyz = np.zeros(3)
    sqcxyz = np.zeros(3)
    for d in range(ndim):
        tc = np.zeros(data.shape[1:])
        for k, off in enumerate(A.offsets):
            if off[d] != 0:
                tc += data[k]
        tc = -diag_sign * tc
        cxyz[d] = tc.sum()
        sqcxyz[d] = (tc * tc).sum()
    mean = cxyz / n
    dev = sqcxyz / n
    dxyz_flag = False
    for d in range(ndim):
        var = dev[d] - mean[d] ** 2
        if mean[d] != 0 and var / (mean[d] ** 2) > 0.1:
            dxyz_flag = True
            break
    cmax = max(cxyz.max(), 0.0) or 1.0
    dxyz = np.empty(3)
    for d in range(3):
        if cxyz[d] > 0:
            dxyz[d] = np.sqrt(cmax / cxyz[d])
        else:
            dxyz[d] = REAL_MAX / 1000
    return dxyz, dxyz_flag


def _collapse_interp(A: StructMatrix, cdir: int):
    """Stencil-collapse interp weights at every fine point
    (pfmg_setup_interp.c CC0): returned arrays are sampled at odd
    cdir-index points by the caller."""
    data = _host_data(A)
    center = np.zeros(data.shape[1:])
    left = np.zeros(data.shape[1:])
    right = np.zeros(data.shape[1:])
    for k, off in enumerate(A.offsets):
        if off[cdir] == 0:
            center += data[k]
        elif off[cdir] < 0:
            left -= data[k]
        else:
            right -= data[k]
    safe = np.where(center == 0, 1.0, center)
    p_lo = np.where(center == 0, 0.0, left / safe)
    p_hi = np.where(center == 0, 0.0, right / safe)
    return p_lo, p_hi


def _take_axis(a, idx, axis):
    sl = [slice(None)] * a.ndim
    sl[axis] = idx
    return a[tuple(sl)]


def _build_P(shape, cdir, p_lo, p_hi):
    """Host sparse P: fine grid -> coarse grid (even cdir indices keep
    identity; odd interpolate from the two flanking coarse points)."""
    nf = shape[cdir]
    nc = (nf + 1) // 2
    cshape = list(shape)
    cshape[cdir] = nc
    cshape = tuple(cshape)

    grids = np.indices(shape)
    rows = np.ravel_multi_index(grids, shape).ravel()
    ci = grids[cdir]

    rows_l, cols_l, vals_l = [], [], []

    # even points: identity
    even = (ci % 2 == 0).ravel()
    tgt = [g.copy() for g in grids]
    tgt[cdir] = ci // 2
    cols = np.ravel_multi_index(tgt, cshape).ravel()
    rows_l.append(rows[even])
    cols_l.append(cols[even])
    vals_l.append(np.ones(int(even.sum())))

    # odd points: p_lo to lower coarse, p_hi to upper coarse
    odd = (ci % 2 == 1).ravel()
    lo = [g.copy() for g in grids]
    lo[cdir] = np.clip((ci - 1) // 2, 0, nc - 1)
    cols_lo = np.ravel_multi_index(lo, cshape).ravel()
    rows_l.append(rows[odd])
    cols_l.append(cols_lo[odd])
    vals_l.append(p_lo.ravel()[odd])

    hi_idx = (ci + 1) // 2
    valid_hi = (hi_idx < nc).ravel() & odd
    hi = [g.copy() for g in grids]
    hi[cdir] = np.clip(hi_idx, 0, nc - 1)
    cols_hi = np.ravel_multi_index(hi, cshape).ravel()
    rows_l.append(rows[valid_hi])
    cols_l.append(cols_hi[valid_hi])
    vals_l.append(p_hi.ravel()[valid_hi])

    n = int(np.prod(shape))
    m = int(np.prod(cshape))
    P = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, m),
    ).tocsr()
    return P, cshape


# ---------------------------------------------------------------------------
# the semicoarsening transfers (device), shared with SMG
# ---------------------------------------------------------------------------

def _axslice(ndim, axis, start, stop):
    sl = [slice(None)] * ndim
    sl[axis] = slice(start, stop)
    return tuple(sl)


def _axstride(ndim, axis, start, step):
    sl = [slice(None)] * ndim
    sl[axis] = slice(start, None, step)
    return tuple(sl)


def semi_restrict(r: torch.Tensor, axis: int, p_lo, p_hi) -> torch.Tensor:
    """b_c = P^T r along `axis` (semi_restrict.c): the even points, plus
    each odd point's p_lo share into its lower and p_hi share into its
    upper coarse neighbour (none past the last)."""
    nd = r.dim()
    nf = r.shape[axis]
    nc = (nf + 1) // 2
    no = nf // 2
    r_odd = r[_axstride(nd, axis, 1, 2)]
    lo_term = p_lo * r_odd  # contributes to coarse k (k = 0..no-1)
    hi_term = p_hi * r_odd  # contributes to coarse k+1
    bc = r[_axstride(nd, axis, 0, 2)].clone()
    bc[_axslice(nd, axis, 0, no)] += lo_term
    nhi = min(no, nc - 1)
    bc[_axslice(nd, axis, 1, 1 + nhi)] += hi_term[_axslice(nd, axis, 0, nhi)]
    return bc


def semi_interp_add(x: torch.Tensor, axis: int, p_lo, p_hi,
                    e_c: torch.Tensor) -> torch.Tensor:
    """x += P e_c along `axis` (semi_interp.c), in place: the even points
    take e_c, odd point k takes p_lo e_c[k] + p_hi e_c[k+1] (the upper
    neighbour 0 past the last coarse point)."""
    nd = x.dim()
    nf = x.shape[axis]
    nc = (nf + 1) // 2
    no = nf // 2
    x[_axstride(nd, axis, 0, 2)] += e_c
    e_lo = e_c[_axslice(nd, axis, 0, no)]
    nhi = min(no, nc - 1)
    e_hi = torch.zeros_like(e_lo)
    e_hi[_axslice(nd, axis, 0, nhi)] = e_c[_axslice(nd, axis, 1, 1 + nhi)]
    x[_axstride(nd, axis, 1, 2)] += p_lo * e_lo + p_hi * e_hi
    return x


def _rr(r) -> torch.Tensor:
    """<r, r>: a grid tensor's flat dot, or the shards' dots in order."""
    return tdot(r, r)


class PFMG:
    def __init__(self, A: StructMatrix, opts: PFMGOptions = PFMGOptions(), *,
                 device=None):
        """`device`: where the levels live and the cycle runs (None: A's
        device); the setup runs on the host."""
        self.opts = opts
        self.device = torch.device(A.device if device is None else device)
        self.levels: list[_Level] = []
        # setup scans .data per stencil entry; expand constant entries
        with timed("STRUCT_SETUP", self.device):
            self._setup(A.densify().to("cpu"))

    # ------------------------------------------------------------------
    def _setup(self, A0: StructMatrix) -> None:
        o = self.opts
        ndim = len(A0.shape)
        shape = tuple(A0.shape)

        max_levels = 1 + sum(int(np.log2(max(s, 1))) + 2 for s in shape)
        if o.max_levels > 0:
            max_levels = min(max_levels, o.max_levels)

        if o.dxyz is not None and all(d > 0 for d in o.dxyz[:ndim]):
            dxyz = np.array(list(o.dxyz) + [0.0] * (3 - len(o.dxyz)))
            dxyz_flag = False
        else:
            dxyz, dxyz_flag = _compute_dxyz(A0)

        A = A0
        coarsen_prev = np.ones(3, dtype=bool)  # forces relax on finest
        sizes = list(shape) + [1] * (3 - ndim)

        for l in range(max_levels):
            # choose cdir (pfmg_setup.c:215-233)
            min_dxyz = dxyz[0] + dxyz[1] + dxyz[2] + 1
            cdir = -1
            alpha = 0.0
            for d in range(ndim):
                if sizes[d] > 1 and dxyz[d] < min_dxyz:
                    min_dxyz = dxyz[d]
                    cdir = d
                alpha += 1.0 / (dxyz[d] * dxyz[d])
            weight = 1.0
            if cdir != -1:
                if dxyz_flag:
                    weight = 2.0 / 3.0
                else:
                    beta = sum(
                        1.0 / (dxyz[d] * dxyz[d]) for d in range(ndim) if d != cdir
                    )
                    frac = 0.0 if beta == alpha else beta / alpha
                    weight = 2.0 / (3.0 - frac) if ndim > 1 else 2.0 / 3.0
                if l == max_levels - 1:
                    cdir = -1
                # periodic-odd guard
                if cdir != -1 and A.periodic[cdir] and A.periodic[cdir] % 2:
                    cdir = -1

            if o.relax_type == 0:
                weight = 1.0
            elif o.jacobi_weight > 0:
                weight = o.jacobi_weight

            if cdir == -1:
                self.levels.append(self._freeze(A, -1, True, weight))
                break

            active = bool(coarsen_prev[cdir])
            if not o.skip_relax:
                active = True
            if active:
                coarsen_prev[:] = False
            coarsen_prev[cdir] = True

            # interp weights at odd points
            with timed("STRUCT_INTERP"):
                p_lo_full, p_hi_full = _collapse_interp(A, cdir)
                nf = A.shape[cdir]
                odd_idx = np.arange(1, nf, 2)
                p_lo = _take_axis(p_lo_full, odd_idx, cdir)
                p_hi = _take_axis(p_hi_full, odd_idx, cdir)
                P, cshape = _build_P(tuple(A.shape), cdir, p_lo_full,
                                     p_hi_full)
            with timed("STRUCT_RAP"):
                M = A.to_scipy()
                Ac_sp = (P.T.tocsr() @ M @ P).tocsr()
                Ac = StructMatrix.from_scipy(Ac_sp, cshape, A.periodic,
                                             device="cpu")

            self.levels.append(
                self._freeze(A, cdir, active, weight, p_lo, p_hi)
            )
            dxyz[cdir] *= 2
            sizes[cdir] = (sizes[cdir] + 1) // 2
            A = Ac

    @timed("STRUCT_FREEZE")
    def _freeze(self, A, cdir, active, weight, p_lo=None, p_hi=None) -> _Level:
        dev = self.device
        diag = A.diagonal().numpy()
        dinv = np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1.0, diag))
        red = None
        if self.opts.relax_type in (2, 3):
            red = parity_mask(A.shape, 0, device=dev)

        def put(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(dev)

        return _Level(
            A=A.boxed().to(dev),
            dinv=put(dinv),
            cdir=cdir,
            active=active,
            weight=float(weight),
            p_lo=put(p_lo),
            p_hi=put(p_hi),
            red_mask=red,
        )

    @property
    def num_levels(self):
        return len(self.levels)

    # ------------------------------------------------------------------
    # device ops
    # ------------------------------------------------------------------
    def _relax(self, lvl: _Level, x, b, sweeps: int, zero_guess: bool):
        if self.opts.relax_type in (2, 3):
            for s in range(sweeps):
                if zero_guess and s == 0:
                    x = tmap(lambda m, d, bb: torch.where(m, d * bb, 0.0),
                             lvl.red_mask, lvl.dinv, b)
                    r = tsub(b, struct_matvec(lvl.A, x))
                    x = tmap(lambda m, d, rr, xx: torch.where(~m, d * rr, xx),
                             lvl.red_mask, lvl.dinv, r, x)
                else:
                    x = red_black_gs(lvl.A, lvl.dinv, x, b, lvl.red_mask)
            return x
        w = lvl.weight
        for s in range(sweeps):
            if zero_guess and s == 0:
                x = tmap(lambda d, bb: w * d * bb, lvl.dinv, b)
            else:
                r = tsub(b, struct_matvec(lvl.A, x))
                x = tmap(lambda xx, d, rr: xx + w * d * rr, x, lvl.dinv, r)
        return x

    def _restrict(self, lvl: _Level, r):
        """b_c = P^T r along cdir (semi_restrict.c)."""
        if lvl.xfer is not None:
            return lvl.xfer.restrict(r)
        return semi_restrict(r, lvl.cdir, lvl.p_lo, lvl.p_hi)

    def _interp_add(self, lvl: _Level, x, e_c):
        """x += P e_c (semi_interp.c), in place on x."""
        if lvl.xfer is not None:
            return lvl.xfer.interp_add(x, e_c)
        return semi_interp_add(x, lvl.cdir, lvl.p_lo, lvl.p_hi, e_c)

    def _vcycle(self, b):
        """One full V-cycle sweep given the level rhs; returns x."""
        o = self.opts
        L = self.num_levels
        lvls = self.levels

        def down(l, bl):
            lvl = lvls[l]
            if l == L - 1:
                return self._relax(lvl, tzeros_like(bl), bl, 1, True)
            if lvl.active:
                x = self._relax(lvl, tzeros_like(bl), bl, o.num_pre_relax,
                                True)
            else:
                x = tzeros_like(bl)
            r = tsub(bl, struct_matvec(lvl.A, x))
            bc = self._restrict(lvl, r)
            ec = down(l + 1, bc)
            x = self._interp_add(lvl, x, ec)
            if lvl.active:
                x = self._relax(lvl, x, bl, o.num_post_relax, False)
            return x

        return down(1, b) if L > 1 else None

    def _fine_correction(self, x, r):
        """Level 0's coarse-grid correction x += P V(R r), in place."""
        if self.num_levels > 1:
            lvl0 = self.levels[0]
            x = self._interp_add(lvl0, x, self._vcycle(self._restrict(lvl0, r)))
        return x

    def cycle(self, f, u=None):
        """One V-cycle with zero initial guess — the preconditioner hook
        (one pfmg_solve.c iteration without the convergence plumbing)."""
        o = self.opts
        lvl0 = self.levels[0]
        zero_guess = u is None
        u = tzeros_like(f) if u is None else tmap(torch.clone, u)
        u = self._relax(lvl0, u, f, o.num_pre_relax, zero_guess)
        r = tsub(f, struct_matvec(lvl0.A, u))
        u = self._fine_correction(u, r)
        u = self._relax(lvl0, u, f, o.num_post_relax, False)
        return u

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    # ------------------------------------------------------------------
    def solve(self, b, x0=None) -> SolverResult:
        """pfmg_solve.c iteration structure: pre-relax L0, residual +
        convergence check, descend/ascend, post-relax L0.  One host read
        an iteration: the residual's squared norm."""
        o = self.opts
        lvl0 = self.levels[0]
        x = tzeros_like(b) if x0 is None else tmap(torch.clone, x0)
        b_dot_b = float(_rr(b))
        bb = b_dot_b if b_dot_b > 0 else 1.0
        eps = o.tol**2
        b0 = tfirst(b)
        norms = torch.full((o.max_iter + 1,), float("nan"), dtype=b0.dtype,
                           device=b0.device)
        zg = bool(o.zero_guess and x0 is None)
        i, rr, done = 0, float("inf"), False
        while i < o.max_iter and not done:
            x = self._relax(lvl0, x, b, o.num_pre_relax, zg)
            r = tsub(b, struct_matvec(lvl0.A, x))
            rr_t = _rr(r)
            norms[i] = torch.sqrt(rr_t)
            rr = float(rr_t)
            done = (rr / bb < eps and i > 0) or b_dot_b == 0.0
            if not done:
                x = self._fine_correction(x, r)
                x = self._relax(lvl0, x, b, o.num_post_relax, False)
            i += 1
            zg = False

        # hypre reports iterations = index of the converged check
        return SolverResult(
            x=x,
            num_iterations=i - 1 if done else i,
            rel_residual_norm=torch.tensor(np.sqrt(rr / bb), dtype=b0.dtype,
                                           device=b0.device),
            converged=done,
            res_norms=norms,
        )
