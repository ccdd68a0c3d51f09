"""SMG — semicoarsening multigrid with plane solves (port of
hypre_tpu/solvers/struct_ls/smg.py).

Reference: struct_ls/smg_setup.c (cdir always the last dim, :98),
smg_setup_interp.c (P stencil = +-1 in cdir; weights from solving the
masked plane systems hypre_SMGSetupInterpOp — A_mask keeps entries whose
cdir offset differs from the P entry's, x=1 elsewhere, relax the target
planes), smg_relax.c (relaxation = solving plane systems; hypre uses a
recursive (d-1)-dimensional SMG as the plane solver), smg_solve.c.

Small planes (<= `_PLANE_DENSE_MAX` points) are solved exactly by
per-plane dense pseudo-inverses (numpy at setup): each relax sweep is one
batched [nplanes, np, np] x [nplanes, np] product on the device.  Larger
planes use the reference's recursive structure, batched: a 2-D SMG over
all planes at once whose line systems are solved exactly by parallel
cyclic reduction (smg_plane.py).  The interpolation weights come from
plane solves on the device (six V-cycles for the recursive planes, as
in the JAX package); the Galerkin products run on the host.  The cycle
is plain functions driven by a host loop (the JAX package compiles each
level's pieces); `solve` reads one number an iteration.

On a sharded grid (parallel/par_struct.py::shard_solver; the setup
stays serial) the cycle takes tuples of grid blocks.  SMG's planes span
the first two axes.  Cut along the last axis, every plane is whole on
one shard and each shard solves its own planes (`WholePlanes`).  Cut along axis 0 or 1, a plane
is spread over shards: the residual is gathered whole (the layout's
all-gather) onto each distinct device of the shards, the serial plane
solve runs there once, and each shard keeps its part (`CutPlanes`),
bitwise the serial update; a distributed plane solve (a PCR across
shards) would avoid the gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...struct.matrix import StructMatrix, struct_matvec
from ...utils.timing import timed
from ..krylov.common import SolverResult, tdot, tfirst, tmap, tsub, tzeros_like
from .pfmg import _build_P, _take_axis, semi_interp_add, semi_restrict

# largest plane (points) solved by precomputed dense inverses; beyond
# this the batched-2D recursive SMG takes over.  Dense storage is
# [nz, npl, npl] per level: 1024 keeps that <= 8 MB a plane-set.
_PLANE_DENSE_MAX = 1024


@dataclasses.dataclass(frozen=True)
class SMGOptions:
    tol: float = 1e-6
    max_iter: int = 200
    num_pre_relax: int = 1
    num_post_relax: int = 1
    max_levels: int = 0
    zero_guess: bool = True


@dataclasses.dataclass
class _Level:
    A: StructMatrix
    cdir: int
    planes: object  # _DensePlanes | _RecursivePlanes
    p_lo: Optional[torch.Tensor] = None
    p_hi: Optional[torch.Tensor] = None
    xfer: object = None  # the sharded transfer (par_struct.ShardedSemi)


class _DensePlanes:
    """Exact plane solves: batched dense inverses."""

    def __init__(self, inv: np.ndarray, device):
        self.inv = torch.from_numpy(inv).to(device)

    def solve(self, rm, cycles: int = 1, batch=None):
        inv = self.inv if batch is None else self.inv[batch]
        return torch.bmm(inv, rm[:, :, None])[:, :, 0]

    def cut(self, planes: slice, device) -> "_DensePlanes":
        """The solver of the planes `planes` only, on `device`."""
        new = _DensePlanes.__new__(_DensePlanes)
        new.inv = self.inv[planes].to(device)
        return new


class _RecursivePlanes:
    """hypre's recursive plane solver, batched: one 2-D SMG V-cycle over
    all planes per relax (smg_relax.c)."""

    def __init__(self, A: StructMatrix, cdir: int, device):
        from .smg_plane import BatchedSMG2D

        shape = tuple(A.shape)
        self.pshape = tuple(s for d, s in enumerate(shape) if d != cdir)
        data = A.data.cpu().numpy()
        other = [d for d in range(len(shape)) if d != cdir]
        entries = {}
        for k, off in enumerate(A.offsets):
            if off[cdir] != 0:
                continue
            # batched [B, n_a1, n_a2] -> semicoarsen LAST remaining axis
            # (hypre 2-D cdir), lines along the first remaining axis:
            # BatchedSMG2D wants [B, coarse_dir, line_dir]
            arr = np.moveaxis(data[k], cdir, 0)
            entries[(int(off[other[1]]), int(off[other[0]]))] = np.ascontiguousarray(
                np.swapaxes(arr, 1, 2)
            )
        self.smg2 = BatchedSMG2D(entries, device=device)

    def solve(self, rm, cycles: int = 1, batch=None):
        nz = rm.shape[0]
        r3 = rm.reshape((nz,) + self.pshape)          # [B, a1, a2]
        r3 = torch.swapaxes(r3, 1, 2)                  # [B, a2, a1]
        x3 = self.smg2.solve(r3.contiguous(), cycles=cycles, batch=batch)
        return torch.swapaxes(x3, 1, 2).reshape(nz, -1)

    def cut(self, planes: slice, device) -> "_RecursivePlanes":
        """The solver of the planes `planes` only, on `device`."""
        new = _RecursivePlanes.__new__(_RecursivePlanes)
        new.pshape = self.pshape
        new.smg2 = self.smg2.cut(planes, device)
        return new


class WholePlanes:
    """The plane solves of a level whose last axis is cut: shard s owns
    the whole planes [a, b) and solves them with its own cut of the
    level's plane solver (on its device)."""

    def __init__(self, planes, layout, cdir: int):
        self.cdir = cdir
        self.starts, self.solvers = [], []
        for s, dev in enumerate(layout.devices):
            a, b = layout.box(s)[cdir]
            self.starts.append(a)
            self.solvers.append(planes.cut(slice(a, b), dev) if b > a else None)

    def update(self, x, r, parity: int) -> tuple:
        a = self.cdir
        out = []
        for xs, rs, z0, P in zip(x, r, self.starts, self.solvers):
            nz = xs.shape[a]
            if P is None or (parity - z0) % 2 >= nz:
                out.append(xs)
                continue
            sel = slice((parity - z0) % 2, None, 2)
            out.append(_plane_add(xs, rs, a, sel, P))
        return tuple(out)


class CutPlanes:
    """The plane solves of a level cut along axis 0 or 1: the residual
    gathered whole onto each distinct shard device, the `parity` planes
    solved there once by the serial solver, each shard keeping its own
    part of the correction (bitwise the serial update)."""

    def __init__(self, planes, layout, cdir: int, device):
        self.layout, self.cdir = layout, cdir
        self.solvers = {d: planes if d == device else planes.cut(slice(None), d)
                        for d in dict.fromkeys(layout.devices)}

    def update(self, x, r, parity: int) -> tuple:
        a, lay = self.cdir, self.layout
        nz = lay.shape[a]
        if parity >= nz:
            return tuple(x)
        sel = slice(parity, None, 2)
        rest = tuple(n for d, n in enumerate(lay.shape) if d != a)
        delta = {}
        for dev, rw in lay.gather(r).items():
            rm = torch.movedim(rw, a, 0).reshape(nz, -1)
            dz = self.solvers[dev].solve(rm[sel], batch=sel)
            delta[dev] = dz.reshape((dz.shape[0],) + rest)
        out = []
        for s, xs in enumerate(x):
            box = [sl for d, sl in enumerate(lay.slices(s)) if d != a]
            d_s = delta[xs.device][(slice(None),) + tuple(box)]
            xm = torch.movedim(xs, a, 0).reshape(nz, -1).clone()
            xm[sel] += d_s.reshape(d_s.shape[0], -1)
            shp = tuple(n for d, n in enumerate(xs.shape) if d != a)
            out.append(torch.movedim(xm.reshape((nz,) + shp), 0, a).contiguous())
        return tuple(out)


def _plane_add(x, r, a: int, sel: slice, planes):
    """x with the planes `sel` (along axis a) corrected by their exact
    solve against r (one half of the plane block-GS relax)."""
    nz = x.shape[a]
    rm = torch.movedim(r, a, 0).reshape(nz, -1)
    xm = torch.movedim(x, a, 0).reshape(nz, -1).clone()
    xm[sel] += planes.solve(rm[sel], batch=sel)
    rest = tuple(s for d, s in enumerate(x.shape) if d != a)
    return torch.movedim(xm.reshape((nz,) + rest), 0, a).contiguous()


def _build_planes(A: StructMatrix, cdir: int, device):
    shape = tuple(A.shape)
    npl = int(np.prod([s for d, s in enumerate(shape) if d != cdir]))
    if npl > _PLANE_DENSE_MAX:
        return _RecursivePlanes(A, cdir, device)
    return _DensePlanes(_plane_inverses(A, cdir), device)


def _plane_inverses(A: StructMatrix, cdir: int) -> np.ndarray:
    """Dense inverse of each cdir-plane's in-plane system (entries with
    zero cdir offset)."""
    shape = tuple(A.shape)
    nz = shape[cdir]
    pshape = tuple(s for d, s in enumerate(shape) if d != cdir)
    npl = int(np.prod(pshape))
    data = A.data.cpu().numpy()
    inv = np.zeros((nz, npl, npl))
    # assemble each plane's 2D stencil matrix
    other = [d for d in range(len(shape)) if d != cdir]
    grids = np.indices(pshape)
    row_id = np.ravel_multi_index(grids, pshape).ravel()
    for z in range(nz):
        rows_l, cols_l, vals_l = [], [], []
        for k, off in enumerate(A.offsets):
            if off[cdir] != 0:
                continue
            tgt = [grids[i] + off[other[i]] for i in range(len(other))]
            ok = np.ones(pshape, dtype=bool)
            for i, t in enumerate(tgt):
                ok &= (t >= 0) & (t < pshape[i])
            col_id = np.ravel_multi_index(
                [np.clip(t, 0, s - 1) for t, s in zip(tgt, pshape)], pshape
            ).ravel()
            sl = [slice(None)] * len(shape)
            sl[cdir] = z
            vals = data[k][tuple(sl)].ravel()
            okf = ok.ravel()
            rows_l.append(row_id[okf])
            cols_l.append(col_id[okf])
            vals_l.append(vals[okf])
        M = sp.coo_matrix(
            (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(npl, npl),
        ).toarray()
        inv[z] = np.linalg.pinv(M, rcond=1e-13)
    return inv


def _smg_interp_weights(A: StructMatrix, cdir: int, planes, device):
    """P weights at every fine point via the masked plane solves
    (smg_setup_interp.c): for P entry with cdir offset o, solve the
    in-plane system against the SUM of couplings with cdir offset -o
    applied to ones.  The right-hand sides are built on the host; the
    plane solves run on `device`."""
    shape = tuple(A.shape)
    nz = shape[cdir]
    pshape = tuple(s for d, s in enumerate(shape) if d != cdir)
    npl = int(np.prod(pshape))
    data = A.data.cpu().numpy()

    other = [d for d in range(len(shape)) if d != cdir]
    grids = np.indices(pshape)

    def inbounds_mask(off):
        """Couplings whose in-plane shifted target leaves the plane hit
        ghost zeros (the reference's relax-based solve sees this
        automatically; smg_setup_interp.c)."""
        ok = np.ones(pshape, dtype=bool)
        for i, d in enumerate(other):
            t = grids[i] + off[d]
            ok &= (t >= 0) & (t < pshape[i])
        return ok.ravel()

    out = {}
    for o in (-1, 1):
        # rhs = -(entries with cdir offset == -o), masked to in-plane bounds
        rhs = np.zeros((nz, npl))
        for k, off in enumerate(A.offsets):
            if off[cdir] == -o:
                mv = np.moveaxis(data[k], cdir, 0).reshape(nz, npl)
                rhs -= mv * inbounds_mask(off)[None, :]
        w = planes.solve(torch.from_numpy(rhs).to(device), cycles=6)
        w = w.cpu().numpy()
        out[o] = np.moveaxis(w.reshape((nz,) + pshape), 0, cdir)
    # weight to the LOWER coarse donor comes from the -1-side response
    # (couplings with cdir offset -1), i.e. the o=+1 masked solve
    return out[1], out[-1]  # p_lo, p_hi


class SMG:
    def __init__(self, A: StructMatrix, opts: SMGOptions = SMGOptions(), *,
                 device=None):
        """`device`: where the levels live and the cycle runs (None: A's
        device)."""
        self.opts = opts
        self.device = torch.device(A.device if device is None else device)
        self.levels: list[_Level] = []
        # setup scans .data per stencil entry; expand constant entries
        with timed("STRUCT_SETUP", self.device):
            self._setup(A.densify().to("cpu"))

    def _setup(self, A0: StructMatrix):
        o = self.opts
        dev = self.device
        A = A0
        ndim = len(A0.shape)
        cdir = ndim - 1  # smg_setup.c:98 — always the last dimension
        max_levels = int(np.log2(max(A0.shape[cdir], 1))) + 2
        if o.max_levels > 0:
            max_levels = min(max_levels, o.max_levels)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        for l in range(max_levels):
            with timed("SMG_PLANES", dev):
                planes = _build_planes(A, cdir, dev)
            if A.shape[cdir] <= 1 or l == max_levels - 1:
                self.levels.append(_Level(A=A.boxed().to(dev), cdir=cdir, planes=planes))
                break
            # interp weights at odd planes; hypre swaps lo/hi roles:
            # at fine plane 2k+1, weight to coarse k is the response from
            # the -1 side
            with timed("STRUCT_INTERP", dev):
                p_lo_full, p_hi_full = _smg_interp_weights(A, cdir, planes, dev)
                nf = A.shape[cdir]
                odd = np.arange(1, nf, 2)
                p_lo = _take_axis(p_lo_full, odd, cdir)
                p_hi = _take_axis(p_hi_full, odd, cdir)
                P, cshape = _build_P(tuple(A.shape), cdir, p_lo_full,
                                     p_hi_full)
            with timed("STRUCT_RAP"):
                M = A.to_scipy()
                Ac = StructMatrix.from_scipy((P.T.tocsr() @ M @ P).tocsr(),
                                             cshape, A.periodic, device="cpu")

            self.levels.append(
                _Level(
                    A=A.boxed().to(dev),
                    cdir=cdir,
                    planes=planes,
                    p_lo=put(p_lo),
                    p_hi=put(p_hi),
                )
            )
            A = Ac

    @property
    def num_levels(self):
        return len(self.levels)

    # ------------------------------------------------------------------
    def _plane_update(self, lvl: _Level, x, b, parity):
        """Solve the `parity` planes' systems exactly with current
        off-plane values (one half of the plane block-GS relax); only
        those planes are solved, the others keep their values."""
        if isinstance(x, torch.Tensor) and parity >= x.shape[lvl.cdir]:
            return x
        r = tsub(b, struct_matvec(lvl.A, x))
        if not isinstance(x, torch.Tensor):
            return lvl.planes.update(x, r, parity)
        return _plane_add(x, r, lvl.cdir, slice(parity, None, 2), lvl.planes)

    def _relax(self, lvl: _Level, x, b, sweeps: int, up: bool = False):
        """Plane block-GS over the two parity spaces; down sweeps use
        ranks (0,1), up sweeps (1,0) (smg_solve.c:213-214, 271-272)."""
        order = (1, 0) if up else (0, 1)
        for _ in range(int(sweeps)):
            for par in order:
                x = self._plane_update(lvl, x, b, par)
        return x

    def _restrict(self, lvl: _Level, r):
        if lvl.xfer is not None:
            return lvl.xfer.restrict(r)
        return semi_restrict(r, lvl.cdir, lvl.p_lo, lvl.p_hi)

    def _interp_add(self, lvl: _Level, x, ec):
        """x += P ec, in place on x."""
        if lvl.xfer is not None:
            return lvl.xfer.interp_add(x, ec)
        return semi_interp_add(x, lvl.cdir, lvl.p_lo, lvl.p_hi, ec)

    def _vcycle(self, l, b):
        """Levels l..coarsest."""
        o = self.opts
        lvl = self.levels[l]
        if l == self.num_levels - 1:
            # coarsest: single plane set — exact plane solve
            x = self._plane_update(lvl, tzeros_like(b), b, 0)
            return self._plane_update(lvl, x, b, 1)
        x = self._relax(lvl, tzeros_like(b), b, o.num_pre_relax)
        ec = self._vcycle(l + 1, self._restrict(
            lvl, tsub(b, struct_matvec(lvl.A, x))))
        x = self._interp_add(lvl, x, ec)
        return self._relax(lvl, x, b, o.num_post_relax, up=True)

    def _fine_correction(self, x, r):
        """Level 0's coarse-grid correction x += P V(R r), in place."""
        if self.num_levels > 1:
            lvl0 = self.levels[0]
            x = self._interp_add(lvl0, x, self._vcycle(1, self._restrict(lvl0, r)))
        return x

    def cycle(self, f, u=None):
        o = self.opts
        lvl0 = self.levels[0]
        u = tzeros_like(f) if u is None else tmap(torch.clone, u)
        u = self._relax(lvl0, u, f, o.num_pre_relax)
        r = tsub(f, struct_matvec(lvl0.A, u))
        u = self._fine_correction(u, r)
        u = self._relax(lvl0, u, f, o.num_post_relax, up=True)
        return u

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    def solve(self, b, x0=None) -> SolverResult:
        """smg_solve.c iteration structure: pre-relax, residual +
        convergence check (i > 0), descend/ascend, post-relax."""
        o = self.opts
        lvl0 = self.levels[0]
        x = tzeros_like(b) if x0 is None else tmap(torch.clone, x0)
        b_dot_b = float(tdot(b, b))
        eps = o.tol**2
        norms = [float("nan")] * (o.max_iter + 1)
        rel = float("inf")
        converged = False
        it_done = 0
        for it in range(o.max_iter):
            x = self._relax(lvl0, x, b, o.num_pre_relax)
            r = tsub(b, struct_matvec(lvl0.A, x))
            rr = float(tdot(r, r))
            norms[it] = float(np.sqrt(rr))
            rel = np.sqrt(rr / max(b_dot_b, 1e-300))
            it_done = it
            if rr / max(b_dot_b, 1e-300) < eps and it > 0:
                converged = True
                break
            x = self._fine_correction(x, r)
            x = self._relax(lvl0, x, b, o.num_post_relax, up=True)
        b0 = tfirst(b)
        return SolverResult(
            x=x,
            num_iterations=it_done,
            rel_residual_norm=torch.tensor(rel, dtype=b0.dtype, device=b0.device),
            converged=converged,
            res_norms=torch.tensor(norms, dtype=b0.dtype, device=b0.device),
        )
