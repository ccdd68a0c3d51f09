"""AMG-DD: algebraic multigrid with domain-decomposed composite grids
(port of hypre_tpu/solvers/amg/amgdd.py).

Reference: parcsr_ls/par_amgdd{,_setup,_solve,_comp_grid}*.c (~6 kLoC):
after a standard BoomerAMG setup, every processor extends its owned
rows AT EVERY LEVEL by a distance-`padding` ring (the composite grid,
par_amgdd_comp_grid.c); one residual communication per outer iteration
feeds independent LOCAL FAC-style V-cycles on each composite hierarchy
(par_amgdd_fac_cycle.c), eliminating the per-level communication of a
standard V-cycle — the communication-avoiding AMG for
latency-dominated machines.

`AMGDD` is the JAX package's host implementation, line for line: it
builds the per-domain composite hierarchies from a BoomerAMG's host
levels and runs the exact owned/ghost-masked FAC cycles in numpy.
`AMGDDDevice` runs every domain's cycles at once on `device`: the
composite levels padded to common shapes and stacked on a leading
domain axis, each composite matvec a batched ELL product whose gather
is a hand kernel on the card (ops/gather_kernel.py): the tiled
take_along_axis (K2 (a)) for float32 vectors, flat_take (K2 (c)) over
the flattened vectors for float64.

`AMGDDDevice(dd, dtype, mesh=...)` splits the domain axis over the
mesh's shards (the JAX package places the stacked levels with a
NamedSharding on the domain axis): shard s holds the stacked levels of
domains [s c, min((s + 1) c, D)), c = ceil(D / S) (the even split; where
S does not divide D the last shards hold fewer, and a shard with none
does no work), on its own device, at the unsharded padded shapes.  A
cycle is one residual distribution (r moved to each shard, one
flat_take a shard), the batched cycle a shard, and one owned-correction
gather: each shard's owned rows written into z on shard 0's device (the
owned rows are disjoint, so the order does not matter).  Without a
mesh the same cycle runs on one shard that holds every domain.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.gather_kernel import (INT32_MAX, flat_take, flat_take_cuda,
                                  flat_take_reference, take_along_axis_cuda,
                                  take_along_axis_reference)
from ..krylov.common import SolverResult
from .boomeramg import BoomerAMG


@dataclasses.dataclass
class AMGDDOptions:
    num_domains: int = 4
    padding: int = 2  # graph-distance ring added per level
    fac_cycles: int = 2  # inner FAC V-cycles per outer iteration
    relax_weight: float = 0.8
    num_relax: int = 2


def _ring(A: sp.csr_matrix, seed_mask: np.ndarray, dist: int) -> np.ndarray:
    """Grow seed_mask by `dist` graph-distance rings of A's pattern."""
    m = seed_mask.copy()
    for _ in range(dist):
        m = m | (np.asarray(np.abs(A) @ m.astype(float)).ravel() > 0)
    return m


class AMGDD:
    """Composite-grid AMG-DD built on an existing BoomerAMG hierarchy."""

    def __init__(self, amg: BoomerAMG, opts: AMGDDOptions = AMGDDOptions()):
        self.amg = amg
        self.opts = opts
        self._setup()

    def _setup(self) -> None:
        o = self.opts
        As = self.amg._host_A
        Ps = [self.amg.host_P(l) for l in range(len(self.amg._host_P))]
        cfs = self.amg._cf
        L = len(As)
        n0 = As[0].shape[0]
        # contiguous fine-level ownership
        bounds = np.linspace(0, n0, o.num_domains + 1).astype(np.int64)
        self.domains = []
        for dom in range(o.num_domains):
            owned = [np.zeros(As[l].shape[0], bool) for l in range(L)]
            owned[0][bounds[dom]:bounds[dom + 1]] = True
            # ownership coarsens with the C points
            for l in range(L - 1):
                cmask = cfs[l] > 0
                owned[l + 1] = owned[l][cmask]
            comp = [
                _ring(As[l], owned[l], o.padding) for l in range(L)
            ]
            # per-level composite operators and transfers (ghost-zeroed)
            levels = []
            for l in range(L):
                idx = np.flatnonzero(comp[l])
                gl = -np.ones(As[l].shape[0], np.int64)
                gl[idx] = np.arange(len(idx))
                Al = As[l][np.ix_(idx, idx)].tocsr()
                dinv = Al.diagonal()
                dinv = np.where(dinv == 0, 0.0, 1.0 / np.where(dinv == 0, 1, dinv))
                entry = dict(
                    idx=idx, gl=gl, A=Al, dinv=dinv,
                    owned=owned[l][idx],
                )
                if l < L - 1:
                    idx_c = np.flatnonzero(comp[l + 1])
                    Pl = Ps[l][np.ix_(idx, idx_c)].tocsr()
                    entry["P"] = Pl
                levels.append(entry)
            # composite coarsest direct solve
            levels[-1]["inv"] = np.linalg.pinv(levels[-1]["A"].toarray())
            self.domains.append(levels)

    def _fac_vcycle(self, levels, l, u, f):
        o = self.opts
        lv = levels[l]
        if l == len(levels) - 1:
            return lv["inv"] @ f
        for _ in range(o.num_relax):
            u = u + o.relax_weight * lv["dinv"] * (f - lv["A"] @ u)
        r = f - lv["A"] @ u
        fc = lv["P"].T @ r
        ec = self._fac_vcycle(levels, l + 1, np.zeros_like(fc), fc)
        u = u + lv["P"] @ ec
        for _ in range(o.num_relax):
            u = u + o.relax_weight * lv["dinv"] * (f - lv["A"] @ u)
        return u

    def cycle(self, r: np.ndarray) -> np.ndarray:
        """One AMG-DD iteration: ONE global residual distribution, then
        independent composite-grid FAC cycles; owned corrections are
        stitched together (par_amgdd_solve.c)."""
        o = self.opts
        n0 = len(r)
        z = np.zeros(n0)
        for levels in self.domains:
            lv0 = levels[0]
            f = r[lv0["idx"]]
            u = np.zeros_like(f)
            for _ in range(o.fac_cycles):
                u = self._fac_vcycle(levels, 0, u, f)
            z[lv0["idx"][lv0["owned"]]] = u[lv0["owned"]]
        return z

    def solve(self, b, x0=None, tol=1e-8, max_iter=100) -> SolverResult:
        A = self.amg._host_A[0]
        x = np.zeros(len(b)) if x0 is None else np.asarray(x0)
        b = np.asarray(b)
        bn = np.linalg.norm(b) or 1.0
        norms = [np.linalg.norm(b - A @ x)]
        it = 0
        while it < max_iter and norms[-1] / bn >= tol:
            x = x + self.cycle(b - A @ x)
            norms.append(np.linalg.norm(b - A @ x))
            it += 1
        return SolverResult(
            x=x,
            num_iterations=it,
            rel_residual_norm=norms[-1] / bn,
            converged=norms[-1] / bn < tol,
            res_norms=np.array(norms),
        )


# ---------------------------------------------------------------------------
# Batched device execution
# ---------------------------------------------------------------------------

def _ell_stack(mats, nrows: int, dtype):
    """(cols int32 [D, nrows, w], vals [D, nrows, w]) of the domains' CSR
    matrices, w the widest row (at least 1); padding is (0, 0)."""
    D = len(mats)
    w = max(int(np.diff(M.indptr).max(initial=1)) for M in mats)
    cols = np.zeros((D, nrows, w), np.int32)
    vals = np.zeros((D, nrows, w), dtype)
    for d, M in enumerate(mats):
        nl = M.shape[0]
        rn = np.diff(M.indptr)
        r = np.repeat(np.arange(nl), rn)
        k = np.arange(M.nnz) - np.repeat(M.indptr[:-1], rn)
        cols[d, r, k] = M.indices
        vals[d, r, k] = M.data
    return cols, vals


@dataclasses.dataclass(frozen=True)
class BatchedELL:
    """One composite operator of every domain as a batched ELL on the
    device: y[d, i] = sum_k vals[d, i, k] * x[d, cols[d, i, k]], x of
    `ncols` entries a domain.  `cols` [D, nrows * w] int32 is
    take_along_axis's index table (K2 (a), float32); `flat` [D, nrows *
    w] int32 = d * ncols + cols is flat_take's over the flattened x
    (K2 (c), float64)."""

    cols: torch.Tensor
    flat: torch.Tensor
    vals: torch.Tensor  # [D, nrows, w]
    ncols: int

    @classmethod
    def build(cls, cols: np.ndarray, vals: np.ndarray, ncols: int, device):
        D, n, w = cols.shape
        if D * n * w > INT32_MAX or D * ncols > INT32_MAX:
            raise ValueError(
                f"AMG-DD: a batched ELL of {D} x {n} x {w} gathers from "
                f"{D} x {ncols} entries needs 64-bit indices; the gather "
                f"kernels index in 32 bits")
        flat = (np.arange(D, dtype=np.int64)[:, None, None] * ncols
                + cols).astype(np.int32)
        dev = torch.device(device)
        return cls(cols=torch.from_numpy(cols.reshape(D, n * w)).to(dev),
                   flat=torch.from_numpy(flat.reshape(D, n * w)).to(dev),
                   vals=torch.from_numpy(vals).to(dev), ncols=ncols)


def batched_gather(B: BatchedELL, u: torch.Tensor) -> torch.Tensor:
    """[D, nrows * w]: u[d, cols[d, j]].  On a CUDA tensor a float32 u
    takes the tiled take_along_axis kernel, a float64 u the flat_take
    kernel; on a CPU tensor their plain versions."""
    u = u.contiguous()
    if u.device.type == "cuda":
        if u.dtype == torch.float32:
            return take_along_axis_cuda(u, B.cols, axis=1)
        return flat_take_cuda(u.reshape(-1), B.flat)
    if u.device.type == "cpu":
        if u.dtype == torch.float32:
            return take_along_axis_reference(u, B.cols, axis=1)
        return flat_take_reference(u.reshape(-1), B.flat)
    raise ValueError(f"batched_gather: no path for device {u.device}")


def batched_ell_spmv(B: BatchedELL, u: torch.Tensor) -> torch.Tensor:
    """[D, nrows]: the gather, then the products and the sum over the
    slots in torch (the JAX package's plain jnp)."""
    D, n, w = B.vals.shape
    return torch.sum(B.vals * batched_gather(B, u).reshape(D, n, w), dim=-1)


class AMGDDDevice:
    """Batched device execution of AMG-DD composite cycles.

    All domains' composite hierarchies are padded to common per-level
    shapes and stacked on a leading DOMAIN axis; one call runs every
    domain's FAC V-cycles simultaneously (batched ELL matvecs, batched
    dense coarse solves).  Communication structure is exactly
    par_amgdd_solve.c's: per outer iteration ONE distribution of the
    global residual into the composite grids and ONE gather of owned
    corrections.  The cycle runs in `dtype` (float32 by default, the
    JAX package's); `cycle` casts r to it.
    """

    def __init__(self, dd: AMGDD, dtype=np.float32, *, device="cuda",
                 mesh=None):
        """`mesh` (parallel/mesh.py): split the domain axis over its
        shards (module docstring); `device` is then shard 0's.  Without
        a mesh, one shard on `device` holds every domain."""
        self.opts = dd.opts
        self.mesh = mesh
        devices = [device] if mesh is None else list(mesh.devices)
        self.device = dev = torch.device(devices[0])
        dtype = np.dtype(dtype)
        self.dtype = getattr(torch, dtype.name)
        self.n0 = dd.amg._host_A[0].shape[0]
        D = len(dd.domains)
        self.num_levels = len(dd.domains[0])
        self.num_shards = S = len(devices)
        c = -(-D // S)
        self.shards = []
        for s, sdev in enumerate(devices):
            d0, d1 = min(s * c, D), min((s + 1) * c, D)
            if d1 > d0:
                self.shards.append(_DDShard(dd, dtype, sdev, s, d0, d1,
                                            self.n0, dev))

    @property
    def levels(self) -> list:
        """Shard 0's stacked levels (every domain's when unsharded)."""
        return self.shards[0].levels

    def _vcycle(self, l, u, f, levels):
        o = self.opts
        lv = levels[l]
        if l == self.num_levels - 1:
            return torch.einsum("dij,dj->di", lv["inv"], f)
        w = o.relax_weight
        for _ in range(o.num_relax):
            u = u + w * lv["dinv"] * (f - batched_ell_spmv(lv["A"], u))
        r = f - batched_ell_spmv(lv["A"], u)
        fc = batched_ell_spmv(lv["R"], r)
        ec = self._vcycle(l + 1, torch.zeros_like(fc), fc, levels)
        u = u + batched_ell_spmv(lv["P"], ec)
        for _ in range(o.num_relax):
            u = u + w * lv["dinv"] * (f - batched_ell_spmv(lv["A"], u))
        return u

    def cycle(self, r):
        """One AMG-DD iteration on every domain at once: z of r's length
        in the cycle's dtype, on shard 0's device."""
        r = r.to(self.dtype)
        rp = torch.cat([r, r.new_zeros(1)])
        z = rp.new_zeros(self.n0, device=self.device)
        for sh in self.shards:
            # ONE residual distribution: r to the shard, one flat_take
            rs = rp if rp.device == sh.device else rp.to(sh.device)
            f = flat_take(rs, sh.gidx)
            u = torch.zeros_like(f)
            for _ in range(self.opts.fac_cycles):
                u = self._vcycle(0, u, f, sh.levels)
            # ONE owned-correction gather, combined on shard 0; the
            # owned rows are disjoint, so z is deterministic
            own = u.reshape(-1)[sh.own_pos]
            z[sh.own_gid] = own.to(self.device)
        return z

    def cycle_launches(self) -> dict:
        """{kernel name: launches} of one `cycle` on the card, the sum of
        `shard_launches`."""
        out = {"take_along_axis": 0, "flat_take": 0}
        for c in self.shard_launches():
            for k, v in c.items():
                out[k] += v
        return out

    def shard_launches(self) -> list:
        """The launches of one `cycle` on each shard: a gather a
        composite matvec (num_relax sweeps before and after, the
        residual, R and P on every level but the coarsest, fac_cycles
        times), take_along_axis for float32 and flat_take for float64,
        and the residual distribution's flat_take; a shard with no
        domains launches nothing."""
        o = self.opts
        mv = o.fac_cycles * (self.num_levels - 1) * (2 * o.num_relax + 3)
        each = ({"take_along_axis": mv, "flat_take": 1}
                if self.dtype == torch.float32
                else {"take_along_axis": 0, "flat_take": mv + 1})
        held = {sh.index for sh in self.shards}
        return [dict(each) if s in held
                else {"take_along_axis": 0, "flat_take": 0}
                for s in range(self.num_shards)]

    @property
    def precond(self):
        return self.cycle


def _stack_levels(dd: AMGDD, dtype, dev, d0: int, d1: int) -> list:
    """The composite levels of domains [d0, d1) stacked on the domain
    axis on `dev`, at the shapes of all the domains (every level padded
    to the largest domain's rows and widest row, as unsharded)."""
    doms = dd.domains
    L = len(doms[0])
    levs = []
    for l in range(L):
        nmax = max(len(dom[l]["idx"]) for dom in doms)
        cols, vals = _ell_stack([dom[l]["A"].tocsr() for dom in doms],
                                nmax, dtype)
        dinv = np.zeros((len(doms), nmax), dtype)
        for d, dom in enumerate(doms):
            dinv[d, :dom[l]["A"].shape[0]] = dom[l]["dinv"]
        ent = dict(A=BatchedELL.build(cols[d0:d1], vals[d0:d1], nmax, dev),
                   dinv=torch.from_numpy(dinv[d0:d1]).to(dev))
        if l < L - 1:
            ncmax = max(len(dom[l + 1]["idx"]) for dom in doms)
            Ps = [dom[l]["P"].tocsr() for dom in doms]
            # R = P^T stored as ELL too, its width from the actual
            # transpose row widths
            pc, pv = _ell_stack(Ps, nmax, dtype)
            rc, rv = _ell_stack([P.T.tocsr() for P in Ps], ncmax, dtype)
            ent["P"] = BatchedELL.build(pc[d0:d1], pv[d0:d1], ncmax, dev)
            ent["R"] = BatchedELL.build(rc[d0:d1], rv[d0:d1], nmax, dev)
        else:
            inv = np.zeros((d1 - d0, nmax, nmax), dtype)
            for d in range(d0, d1):
                nl = doms[d][l]["A"].shape[0]
                inv[d - d0, :nl, :nl] = doms[d][l]["inv"]
            ent["inv"] = torch.from_numpy(inv).to(dev)
        levs.append(ent)
    return levs


class _DDShard:
    """Shard `index` of an AMGDDDevice: domains [d0, d1) on
    `device`, with the residual distribution's index table, the owned
    rows' positions in its flattened u, and their global rows on
    `target` (where the corrections are combined)."""

    def __init__(self, dd: AMGDD, dtype, device, index: int, d0: int,
                 d1: int, n0: int, target):
        self.index = index
        self.device = dev = torch.device(device)
        self.levels = _stack_levels(dd, dtype, dev, d0, d1)
        cmax0 = max(len(dom[0]["idx"]) for dom in dd.domains)
        gidx = np.full((d1 - d0, cmax0), n0, np.int32)  # pad -> zero sink
        pos, gid = [], []
        for d in range(d0, d1):
            lv0 = dd.domains[d][0]
            idx = lv0["idx"]
            gidx[d - d0, :len(idx)] = idx
            own = np.flatnonzero(lv0["owned"])
            pos.append((d - d0) * cmax0 + own)
            gid.append(idx[own])
        self.gidx = torch.from_numpy(gidx).to(dev)
        self.own_pos = torch.from_numpy(np.concatenate(pos)).to(dev)
        self.own_gid = torch.from_numpy(
            np.concatenate(gid).astype(np.int64)).to(target)
