"""Overlapping Schwarz block smoother/preconditioner (port of
hypre_tpu/solvers/amg/schwarz.py).

Reference: parcsr_ls/schwarz.c (3.7 kLoC — overlapping Schwarz with
variants 0-3: multiplicative/additive x single-domain/multiplicative
among ranks; domains from rows or aggregates).

Design (the JAX package's): contiguous row blocks with symmetric overlap
or graph aggregates as the domains; the block inverses are computed
dense on the host at setup (pinv), and an apply is a gather of the
domains' residual rows, one batched [nb, w, w] x [nb, w] product in the
vectors' dtype (`torch.einsum`; the JAX package's is a jnp.einsum, no
Pallas kernel) and a scatter-add (`index_add_`; on CUDA it adds with
atomics, so overlapping corrections of the additive variant sum in no
fixed order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix
from ...utils.errors import generic_error
from .smoothed_aggregation import _aggregate


@dataclasses.dataclass(frozen=True)
class SchwarzOptions:
    block_size: int = 64
    overlap: int = 8  # rows of overlap on each side
    # schwarz.c variants (HYPRE_SchwarzSetVariant 0-3), re-expressed for
    # a data-parallel machine:
    #   "ras"            restricted additive (each row owned by one
    #                    domain; hypre's hybrid default behaves this way
    #                    across ranks)
    #   "additive"       classical additive Schwarz (variant 2):
    #                    overlapping corrections SUM, damped by 1/k on
    #                    rows covered k times
    #   "multiplicative" two-color multiplicative (variants 0/3's
    #                    sequential sweep re-expressed: even blocks
    #                    update, residual refreshes, odd blocks update —
    #                    the color classes are the parallel width)
    variant: str = "ras"
    # subdomain construction:
    #   "rows"        uniform contiguous row blocks (block_size/overlap)
    #   "agglomerate" graph-agglomerated domains (schwarz.c
    #                 hypre_AMGCreateDomainDof domain_type 2 role: each
    #                 domain = the rows of one connectivity aggregate;
    #                 overlap > 0 adds the domains' 1-ring A-neighbors,
    #                 RAS-owned rows stay the aggregate).  The
    #                 agglomeration is the femli greedy root scheme, not
    #                 hypre_AMGeAgglomerate's weighted matching.
    domain: str = "rows"


def _domains(As: sp.csr_matrix, opts: SchwarzOptions):
    """[(rows of the domain, which of them it owns)] in domain order."""
    n = As.shape[0]
    if opts.domain == "agglomerate":
        pat = As + As.T
        agg = _aggregate(pat.tocsr())
        doms = []
        for k in range(int(agg.max()) + 1):
            core = np.flatnonzero(agg == k)
            rows = core
            if opts.overlap > 0:
                ring = np.unique(pat[core].tocoo().col)
                rows = np.unique(np.concatenate([core, ring]))
            doms.append((rows, np.isin(rows, core)))
        return doms
    bs, ov = opts.block_size, opts.overlap
    doms = []
    for s in range(0, n, bs):
        rows = np.arange(max(0, s - ov), min(n, s + bs + ov))
        doms.append((rows, (rows >= s) & (rows < min(n, s + bs))))
    return doms


@dataclasses.dataclass(frozen=True)
class SchwarzData:
    """The RAS apply operands — the BoomerAMG smooth_type 6 level
    smoother (par_amg.h smooth_type; par_cycle.c: levels below
    smooth_num_levels call HYPRE_SchwarzSolve instead of relaxation)."""

    inv: torch.Tensor  # float64 [nb, w, w] block pinvs
    idx: torch.Tensor  # int64 [nb, w] global rows (pad -> n sink)
    own: torch.Tensor  # bool [nb, w] RAS ownership mask
    n: int


def _schwarz_data(As: sp.csr_matrix, opts: SchwarzOptions, device) -> SchwarzData:
    n = As.shape[0]
    doms = _domains(As, opts)
    width = (max(len(r) for r, _ in doms) if opts.domain == "agglomerate"
             else opts.block_size + 2 * opts.overlap)
    nb = len(doms)
    inv = np.zeros((nb, width, width))
    idx = np.full((nb, width), n, dtype=np.int64)  # pad -> sink
    own = np.zeros((nb, width), dtype=bool)  # restricted (RAS) scatter
    for k, (rows, owned) in enumerate(doms):
        blk = As[rows][:, rows].toarray()
        inv[k, : len(rows), : len(rows)] = np.linalg.pinv(blk, rcond=1e-12)
        idx[k, : len(rows)] = rows
        own[k, : len(rows)] = owned
    dev = torch.device(device)
    return SchwarzData(inv=torch.from_numpy(inv).to(dev),
                       idx=torch.from_numpy(idx).to(dev),
                       own=torch.from_numpy(own).to(dev), n=n)


def _block_solves(sd: SchwarzData, r):
    """[nb, w]: each domain's pinv times its residual rows (the pads read
    the sink 0)."""
    rb = torch.cat([r, r.new_zeros(1)])[sd.idx]
    return torch.einsum("kij,kj->ki", sd.inv.to(r.dtype), rb)


def _scatter(sd: SchwarzData, zb, dtype):
    z = torch.zeros(sd.n + 1, dtype=dtype, device=zb.device)
    z.index_add_(0, sd.idx.reshape(-1), zb.reshape(-1))
    return z[: sd.n]


class Schwarz:
    def __init__(self, A: CSRMatrix, opts: SchwarzOptions = SchwarzOptions(),
                 *, device="cuda"):
        self.opts = opts
        self.n = A.num_rows
        self._matvec = None
        self.data = _schwarz_data(A.to_scipy().tocsr(), opts, device)

    def solve(self, r):
        """Apply one Schwarz sweep per the configured variant."""
        if self.opts.variant == "additive":
            return self._additive(r)
        if self.opts.variant == "multiplicative":
            return self._multiplicative(r)
        return schwarz_apply(self.data, r)

    def _additive(self, r):
        """Classical additive Schwarz (schwarz.c variant 2): overlapped
        corrections sum; rows covered k times are scaled 1/k
        (partition-of-unity damping, the usual AS stabilization)."""
        sd = self.data
        z = _scatter(sd, _block_solves(sd, r), r.dtype)
        cnt = _scatter(sd, (sd.idx < sd.n).to(r.dtype), r.dtype)
        return z / torch.clamp_min(cnt, 1.0)

    def _multiplicative(self, r):
        """Two-color multiplicative Schwarz (variants 0/3's sequential
        domain sweep with color classes as the parallel width): even
        blocks correct, the residual refreshes through A, odd blocks
        correct the remainder.  Needs the operator: set via attach()."""
        if self._matvec is None:
            raise generic_error(
                "multiplicative Schwarz needs attach(matvec) for the "
                "inter-color residual refresh")
        sd = self.data
        zb = _block_solves(sd, r)
        even = (torch.arange(zb.shape[0], device=zb.device) % 2 == 0)[:, None]
        z = _scatter(sd, torch.where(sd.own & even, zb, 0.0), r.dtype)
        r2 = r - self._matvec(z)
        zb2 = torch.where(sd.own & ~even, _block_solves(sd, r2), 0.0)
        return z + _scatter(sd, zb2, r.dtype)

    def attach(self, matvec):
        """Provide A@x for the multiplicative variant's residual refresh."""
        self._matvec = matvec
        return self

    @property
    def precond(self):
        return self.solve


def build_schwarz_data(A: CSRMatrix, opts: SchwarzOptions = SchwarzOptions(),
                       *, device="cuda") -> SchwarzData:
    return _schwarz_data(A.to_scipy().tocsr(), opts, device)


def schwarz_apply(sd: SchwarzData, r):
    """Restricted additive Schwarz: solve on the overlapped blocks,
    scatter only the owned rows."""
    zb = torch.where(sd.own, _block_solves(sd, r), 0.0)
    return _scatter(sd, zb, r.dtype)


def schwarz_smooth(sd: SchwarzData, matvec, u, f, weight=1.0):
    """u += w * M^{-1} (f - A u) — one Schwarz smoothing sweep."""
    return u + weight * schwarz_apply(sd, f - matvec(u))
