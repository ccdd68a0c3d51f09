"""Distributed hybrid Gauss-Seidel, relax 3 / 4 / 6 and 13 / 14 / 8
(port of hypre_tpu/parallel/par_gs.py).

Reference: par_relax.c:1050-1086: hypre's hybrid smoothers are defined
by the process decomposition.  Within a rank the sweep is sequential
Gauss-Seidel over the local diagonal block (latest values); across
ranks it is Jacobi (off-rank columns read the iterate frozen at the
sweep's start).  Each shard's diagonal block gets its own wavefront
schedule (solvers/amg/relax.py::build_gs_schedule, on the shard's
device), and a sweep runs `gauss_seidel` once a shard on
g = f - A_offshard u_frozen, computed once a sweep as
matvec(u) - diag_block_matvec(u): one `gs_sweep` launch a shard on the
card (ops/gs_kernel.py), the plain version on the CPU.

The l1 variants (13 / 14 / 8) divide by hypre's option-4 l1 norm
|a_ii| + sum_offd |a_ij|, "offd" meaning out-of-shard, its sign the
diagonal's: the divisor depends on the shard count, as hypre's does on
the rank count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from ..solvers.amg.relax import build_gs_schedule, gauss_seidel


@dataclasses.dataclass
class ParGSSchedule:
    """Shard s's schedule over its n_local[s] rows on its device (None
    for an empty shard); `per` the padded block length."""

    scheds: list
    n_local: list
    per: int


def build_par_gs_schedule(Ah, part, mesh, axis: str, forward: bool, l1: bool,
                          dtype=None, mask=None) -> ParGSSchedule:
    """Host: every shard's diagonal-block schedule.

    Ah: global scipy CSR; part: its block partition.  l1: divisor
    |a_ii| + sum_{j off-shard} |a_ij| (option-4 l1 norm,
    par_relax_more.c), else the diagonal; 1 where that is 0.  mask: a
    GLOBAL boolean row mask (CF_marker > 0 for the C half-sweep, its
    complement for F): relax_order 1 (par_cycle.c:398) relaxes only the
    masked rows, reading the latest in-shard values and the sweep-start
    off-shard ones.  `dtype` is the JAX signature's; the schedules hold
    float64, as the port's GS does."""
    S = mesh.shape[axis]
    per = part.rows_per_shard
    n = Ah.shape[0]
    scheds, n_local = [], []
    for s in range(S):
        lo = s * per
        hi = min(lo + per, n)
        n_local.append(max(hi - lo, 0))
        if hi <= lo:
            scheds.append(None)
            continue
        block = Ah[lo:hi, lo:hi].tocsr()
        block.sort_indices()
        diag = block.diagonal()
        if l1:
            full = Ah[lo:hi].tocsr()
            row_abs = np.asarray(np.abs(full).sum(axis=1)).ravel()
            in_abs = np.asarray(np.abs(Ah[lo:hi, lo:hi]).sum(axis=1)).ravel()
            div = np.abs(diag) + (row_abs - in_abs)
            div = np.where(diag < 0, -div, div)  # sign follows diagonal
        else:
            div = diag
        div = np.where(div == 0, 1.0, div)
        scheds.append(build_gs_schedule(
            CSRMatrix.from_scipy(block), forward=forward, divisor=div,
            mask=None if mask is None else np.asarray(mask[lo:hi]),
            device=mesh.devices[s]))
    return ParGSSchedule(scheds=scheds, n_local=n_local, per=per)


def par_gauss_seidel(sched: ParGSSchedule, u, g, weight=1.0) -> tuple:
    """One hybrid sweep: each shard's sequential GS over its diagonal
    block with right-hand side g = f - A_offshard u_frozen.  u, g:
    sharded vectors (S blocks of `per`); the padding rows stay as
    they are."""
    out = []
    for sc, nl, us, gs in zip(sched.scheds, sched.n_local, u, g):
        if sc is None:
            out.append(us)
        elif nl == sched.per:
            out.append(gauss_seidel(sc, us, gs, weight))
        else:
            out.append(torch.cat([gauss_seidel(sc, us[:nl], gs[:nl], weight),
                                  us[nl:]]))
    return tuple(out)
