"""Distributed BoomerAMG cycles over a shard mesh (port of
hypre_tpu/parallel/par_amg.py).

Reference analog: parcsr_ls, every AMG phase on row-partitioned
matrices with CommPkg exchanges.  The finest levels' A / P / R become
row-sharded operators: ParDIA (strip halos, K1) for a lattice stencil
whose diagonals stay within one shard, ParCSR (halo plans, the ELL
kernel) otherwise.  Levels below `repl_threshold` rows form the
replicated tail, refrozen from the host hierarchy (hypre's redundant
coarse-grid gather, par_amg_setup.c seq_threshold / gen_redcs_mat.c).

One deliberate deviation, with the same arithmetic: the JAX package
computes the tail redundantly on every device; the port gathers f's
blocks onto shard 0's device, runs the port's cycle over the refrozen
tail there once, and splits the result back into blocks.

The setup is the single-device host setup, so the math is the serial
hierarchy's and iteration counts are partition-invariant for the
Jacobi family (the .saved cross-np contract); the hybrid GS family
depends on the shard count, as hypre's does on the rank count.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ..ops.csr import CSRMatrix
from .mesh import AXIS
from .par_csr import ParCSR
from .par_dia import ParDIA, dia_table
from .par_gs import build_par_gs_schedule, par_gauss_seidel
from .partition import block_partition


@dataclasses.dataclass
class _ParLevel:
    A: object  # ParCSR | ParDIA
    P: ParCSR | None
    R: ParCSR | None
    l1inv: tuple  # sharded, padded by rows
    dinv: tuple
    cmask: tuple  # sharded bool (CF_marker > 0), for relax_order=1
    gs: dict | None = None  # (forward, l1) -> ParGSSchedule or (C, F) pair


# Jacobi-family relax types: simultaneous diagonal-scaled sweeps, the
# same math at any shard count.  18 = l1-Jacobi, 0 / 7 weighted Jacobi,
# 5 chaotic GS (== Jacobi on a data-parallel machine).
_JACOBI_TYPES = frozenset({0, 5, 7})
_L1_JACOBI_TYPES = frozenset({18})
# the hybrid GS family (par_relax.c:1050-1086), per shard (par_gs.py);
# 1 / 2 ("sequential" GS) run with hybrid semantics too: hypre's true
# cross-rank order would serialize the mesh (the JAX package's choice)
_GS_FWD = frozenset({1, 3, 13})
_GS_BWD = frozenset({2, 4, 14})
_GS_SYM = frozenset({6, 8})
_GS_L1 = frozenset({8, 13, 14})
_GS_TYPES = _GS_FWD | _GS_BWD | _GS_SYM
_L1_TYPES = frozenset({8, 13, 14, 18})


def _map(fn, *vecs) -> tuple:
    """fn over the shards' blocks of sharded vectors."""
    return tuple(fn(*blocks) for blocks in zip(*vecs))


class ParAMG:
    """Run a (host-setup) BoomerAMG hierarchy on a mesh.

    Honours the hierarchy's smoother options (relax_down / up, weight,
    sweeps, CF ordering) and cycle_type on the sharded levels; the
    replicated tail runs the port's cycle machinery unchanged."""

    def __init__(self, amg, mesh, axis: str = AXIS,
                 repl_threshold: int = 8192, dtype=None,
                 dia_max_offsets: int = 48):
        self.amg = amg
        self.mesh = mesh
        self.axis = axis
        self.repl_threshold = repl_threshold
        dt = np.dtype(dtype or amg.opts.dtype)
        S = mesh.shape[axis]

        rtypes = {amg.opts.relax_down, amg.opts.relax_up}
        unsupported = rtypes - _JACOBI_TYPES - _L1_JACOBI_TYPES - _GS_TYPES
        if unsupported:
            raise NotImplementedError(
                f"ParAMG: relax type(s) {sorted(unsupported)} have no "
                "sharded implementation (supported: Jacobi "
                f"{sorted(_JACOBI_TYPES | _L1_JACOBI_TYPES)} and hybrid "
                f"GS {sorted(_GS_TYPES)})")
        self._gs_cf = amg.opts.relax_order == 1 and bool(rtypes & _GS_TYPES)
        gs_needed = set()  # (forward, l1)
        for rt in rtypes & _GS_TYPES:
            l1 = rt in _GS_L1
            if rt in _GS_FWD or rt in _GS_SYM:
                gs_needed.add((True, l1))
            if rt in _GS_BWD or rt in _GS_SYM:
                gs_needed.add((False, l1))

        self.par_levels: list[_ParLevel] = []
        self.split = 0
        L = amg.num_levels
        for l in range(L):
            n = amg._host_A[l].shape[0]
            if n < repl_threshold or l == L - 1:
                break
            self.split = l + 1
            Ah = amg._host_A[l]
            Ap = self._shard_operator(Ah, mesh, axis, dt, dia_max_offsets, S)
            Pl = amg.host_P(l)
            Pp = ParCSR(Pl, mesh, axis, col_part=block_partition(Pl.shape[1], S),
                        dtype=dt)
            Rp = ParCSR(Pl.T.tocsr(), mesh, axis, col_part=Ap.part, dtype=dt)
            diag = Ah.diagonal()
            l1 = np.asarray(np.abs(Ah).sum(axis=1)).ravel()
            gs = None
            if gs_needed:
                def build(key, m=None):
                    return build_par_gs_schedule(
                        Ah, Ap.part, mesh, axis, forward=key[0], l1=key[1],
                        dtype=dt, mask=m)

                if self._gs_cf:
                    # relax_order 1: a (C, F) pair of half-sweep schedules
                    # a direction (par_cycle.c:398 CF ordering)
                    cm = amg._cf[l] > 0
                    gs = {key: (build(key, cm), build(key, ~cm))
                          for key in gs_needed}
                else:
                    gs = {key: build(key) for key in gs_needed}
            self.par_levels.append(_ParLevel(
                A=Ap, P=Pp, R=Rp,
                l1inv=Ap.pad_vec(np.where(
                    l1 == 0, 0.0, 1.0 / np.where(l1 == 0, 1, l1)).astype(dt)),
                dinv=Ap.pad_vec(np.where(
                    diag == 0, 0.0, 1.0 / np.where(diag == 0, 1, diag)).astype(dt)),
                cmask=Ap.pad_vec(amg._cf[l] > 0),
                gs=gs))

        # the replicated tail, refrozen from the host hierarchy on shard
        # 0's device (the base instance may hold lattice forms whose
        # vector sizes differ); its levels are coarse ones (mat_dtype)
        self.tail_amg = copy.copy(amg)
        self.tail_amg.device = mesh.devices[0]
        self.tail_amg.levels = []
        self.tail_levels = []
        for l in range(self.split, L):
            last = l == L - 1
            self.tail_levels.append(self.tail_amg._freeze_level(
                amg._host_A[l], None if last else amg.host_P(l), None,
                None if last else amg._cf[l], fine=False, coarsest=last))

    @staticmethod
    def _shard_operator(Ah, mesh, axis, dt, dia_max_offsets, S):
        """ParDIA when the operator is a lattice stencil whose diagonals
        stay within one shard of halo; ParCSR otherwise."""
        n, m = Ah.shape
        per = block_partition(n, S).rows_per_shard
        if n == m and Ah.nnz:
            rows = np.repeat(np.arange(n), np.diff(Ah.indptr))
            offs = np.unique(Ah.indices - rows)
            if (len(offs) <= dia_max_offsets
                    and int(np.abs(offs).max(initial=0)) <= per):
                data, offsets = dia_table(Ah, dtype=dt)
                return ParDIA(data, offsets, n, mesh, axis)
        return ParCSR(CSRMatrix.from_scipy(Ah), mesh, axis, dtype=dt)

    # ------------------------------------------------------------------
    def cycle(self, f, u=None) -> tuple:
        """One multigrid cycle on sharded vectors (f's padded blocks),
        honouring the hierarchy's cycle_type (1 = V, 2 = W)."""
        return self._run(self._steps(0, u is None),
                         _map(torch.zeros_like, f) if u is None else u, f)

    def _steps(self, l: int, u_zero: bool):
        """The cycle from level l, as the steps `_run` executes and
        `cycle_launches` counts:
          ("gs", l, sched): one hybrid GS half-sweep over `sched`;
          ("jacobi", l, relax_type, half, u_zero): one Jacobi-family
              sweep, over the C ("c") or F ("f") points or all (None);
              u_zero: U[l] is exactly zero, so the A @ 0 matvec is
              skipped;
          ("restrict", l): F[l+1] = R (F[l] - A U[l]), U[l+1] = 0;
          ("prolong", l): U[l] += P U[l+1];
          ("tail", l, u_zero): the replicated tail's cycle (`_tail`)."""
        o = self.amg.opts
        if l == self.split:
            yield "tail", l, u_zero
            return
        yield from self._smooth_steps(l, o.relax_down, False, u_zero)
        # par_cycle.c's lev_counter: every level below the finest
        # descends cycle_type times, the residual recomputed from the
        # improved u and re-smoothed between visits (the coarse guess
        # restarts at zero each visit)
        for _ in range(1 if l == 0 else max(1, o.cycle_type)):
            yield "restrict", l
            yield from self._steps(l + 1, True)
            yield "prolong", l
            yield from self._smooth_steps(l, o.relax_up, True, False)

    def _smooth_steps(self, l: int, relax_type: int, up: bool, u_zero: bool):
        """One smoothing call's sweeps: Jacobi families as simultaneous
        sweeps, hybrid GS (par_relax.c:1050-1086) as per-shard
        sequential GS + Jacobi across shards (par_gs.py); relax_order 1
        runs C then F down, F then C up (par_cycle.c:398)."""
        o = self.amg.opts
        sweeps = max(1, o.num_sweeps)
        if relax_type in _GS_TYPES:
            directions = []
            if relax_type in _GS_FWD or relax_type in _GS_SYM:
                directions.append(True)
            if relax_type in _GS_BWD or relax_type in _GS_SYM:
                directions.append(False)
            l1 = relax_type in _GS_L1
            for _ in range(sweeps):
                for fwd in directions:
                    sched = self.par_levels[l].gs[(fwd, l1)]
                    if isinstance(sched, tuple):
                        sc, sf = sched
                        sched = (sf, sc) if up else (sc, sf)
                    for h in (sched if isinstance(sched, tuple) else (sched,)):
                        yield "gs", l, h
            return
        halves = (("f", "c") if up else ("c", "f")) if o.relax_order == 1 \
            else (None,)
        for s in range(sweeps):
            for j, half in enumerate(halves):
                yield "jacobi", l, relax_type, half, u_zero and s == 0 and j == 0

    def smooth(self, l: int, relax_type: int, u, f, up: bool,
               u_zero: bool = False) -> tuple:
        """One smoothing call on sharded level l (`_smooth_steps`)."""
        return self._run(self._smooth_steps(l, relax_type, up, u_zero),
                         u, f, l)

    def _run(self, steps, u, f, top: int = 0) -> tuple:
        """Execute steps (`_steps`, `_smooth_steps`) on sharded vectors
        from level `top`; U[l], F[l] are level l's blocks."""
        w = self.amg.opts.relax_weight
        U, F = {top: u}, {top: f}
        for step in steps:
            kind, l = step[0], step[1]
            if kind == "tail":
                U[l] = self._tail(U[l], F[l], step[2])
                continue
            lvl = self.par_levels[l]
            mv = lvl.A.matvec_fn
            if kind == "gs":
                # the off-shard part frozen at the half-sweep's start
                # (the across-rank Jacobi half of the hybrid; one
                # exchange a hypre_BoomerAMGRelax call)
                g = _map(lambda fs, a, d: fs - (a - d),
                         F[l], mv(U[l]), lvl.A.diag_matvec_fn(U[l]))
                U[l] = par_gauss_seidel(step[2], U[l], g, w)
            elif kind == "jacobi":
                _, _, rt, half, u_zero = step
                div = lvl.l1inv if rt in _L1_TYPES else lvl.dinv
                r = F[l] if u_zero else _map(torch.sub, F[l], mv(U[l]))
                upd = _map(lambda dv, rs: w * dv * rs, div, r)
                if half is not None:
                    mask = (lvl.cmask if half == "c"
                            else _map(torch.logical_not, lvl.cmask))
                    upd = _map(lambda m, us: torch.where(m, us, 0.0),
                               mask, upd)
                U[l] = upd if u_zero else _map(torch.add, U[l], upd)
            elif kind == "restrict":
                F[l + 1] = lvl.R.matvec_fn(_map(torch.sub, F[l], mv(U[l])))
                U[l + 1] = _map(torch.zeros_like, F[l + 1])
            else:
                U[l] = _map(torch.add, U[l], lvl.P.matvec_fn(U[l + 1]))
        return U[top]

    def _tail_steps(self, u_zero: bool):
        """The replicated tail's cycle steps (`BoomerAMG._mult_steps`): a
        W-cycle descends cycle_type times at a mid-hierarchy top."""
        o = self.amg.opts
        top = max(1, o.cycle_type) if self.split > 0 else 1
        return self.tail_amg._mult_steps(len(self.tail_levels), u_zero,
                                         top_counter=top)

    def _tail(self, u, f, u_zero: bool) -> tuple:
        """The replicated tail: f's blocks gathered onto shard 0's
        device, one cycle of the port's machinery there, the result
        split back into blocks."""
        dev0 = self.mesh.devices[0]
        n = self.tail_levels[0].dinv.shape[0]
        per = f[0].shape[0]
        f_r = torch.cat([b.to(dev0) for b in f])[:n]
        u_r = torch.cat([b.to(dev0) for b in u])[:n]
        u_r = self.tail_amg._run(self.tail_levels, self._tail_steps(u_zero),
                                 u_r, f_r)
        u_r = torch.cat([u_r, u_r.new_zeros(per * len(f) - n)])
        return tuple(u_r[s * per:(s + 1) * per].to(b.device)
                     for s, b in enumerate(f))

    def cycle_launches(self) -> dict:
        """{kernel: launches} of one `cycle` from a zero guess on CUDA
        vectors: the cycle's own steps (`_steps`) with the launches of
        each: each sharded product's (`kernel_launches`), one
        `gs_sweep` a shard with rows a hybrid GS half-sweep, the tail's
        steps (`BoomerAMG.steps_launches`)."""
        out: dict = {}

        def add(counts: dict, k: int = 1):
            for name, c in counts.items():
                out[name] = out.get(name, 0) + k * c

        for step in self._steps(0, True):
            kind, l = step[0], step[1]
            if kind == "tail":
                add(self.tail_amg.steps_launches(self.tail_levels,
                                                 self._tail_steps(step[2])))
                continue
            lvl = self.par_levels[l]
            if kind == "gs":
                add(lvl.A.kernel_launches(), 2)  # A u and A_diag u
                add({"gs_sweep": sum(sc is not None for sc in step[2].scheds)})
            elif kind == "jacobi":
                if not step[4]:
                    add(lvl.A.kernel_launches())
            elif kind == "restrict":
                add(lvl.A.kernel_launches())
                add(lvl.R.kernel_launches())
            else:
                add(lvl.P.kernel_launches())
        return out

    @property
    def precond(self):
        return lambda r: self.cycle(r)

    @property
    def fine(self):
        return self.par_levels[0].A if self.par_levels else None
