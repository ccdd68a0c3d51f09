"""Batched 2-D SMG — the recursive plane solver under 3-D SMG (port of
hypre_tpu/solvers/struct_ls/smg_plane.py).

Reference: struct_ls/smg_relax.c — hypre's 3-D SMG relaxation solves
each cdir-plane with a recursive (d-1)-dimensional SMG (one V-cycle per
relax), whose own relaxation solves lines exactly (cyclic reduction,
struct_ls/cyclic_reduction.c).

All planes of a level are solved together: every 2-D SMG level is a
batched [B, n2, n1] stencil problem (B = number of planes), relaxed by
parity line block-GS whose line systems are solved exactly with
parallel cyclic reduction along the minor axis (over B x n2 lines at
once; each level's PCR elimination of its fixed bands is computed once,
`pcr_factor`, and each relaxation solves only the lines of the parity
it updates).  Interpolation weights come from the same line systems,
solved on the host (`_thomas_host`); coarse 2-D operators are exact Galerkin RAPs
assembled per plane on the host at setup.  The JAX package's per-level
`jax.jit` closures are plain functions here, driven by a host loop.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .cyclic_reduction import pcr_apply, pcr_factor
from .pfmg import semi_interp_add, semi_restrict


def _thomas_host(lower, diag, upper, rhs):
    """Vectorized-batch host tridiagonal solve along the last axis."""
    n = rhs.shape[-1]
    c = np.zeros_like(rhs)
    d = np.zeros_like(rhs)
    safe = lambda x: np.where(x == 0, 1.0, x)
    c[..., 0] = upper[..., 0] / safe(diag[..., 0])
    d[..., 0] = rhs[..., 0] / safe(diag[..., 0])
    for i in range(1, n):
        den = safe(diag[..., i] - lower[..., i] * c[..., i - 1])
        if i < n - 1:
            c[..., i] = upper[..., i] / den
        d[..., i] = (rhs[..., i] - lower[..., i] * d[..., i - 1]) / den
    x = np.zeros_like(rhs)
    x[..., -1] = d[..., -1]
    for i in range(n - 2, -1, -1):
        x[..., i] = d[..., i] - c[..., i] * x[..., i + 1]
    return x


def _plane_terms(entries):
    """[(first point, points, first x, coefficients [B, points])] of each
    entry (d2, d1) on the raveled planes [B, n2 * n1]: y[:, p0 : p0 + m]
    += c * x[:, x0 : x0 + m], c the entry with the couplings that leave
    the plane zeroed (the entry itself where they are 0 already)."""
    terms = []
    for (d2, d1), c in entries.items():
        B, n2, n1 = c.shape
        f = d2 * n1 + d1
        cm = torch.zeros_like(c)
        sl = (slice(None), slice(max(0, -d2), n2 - max(0, d2)),
              slice(max(0, -d1), n1 - max(0, d1)))
        cm[sl] = c[sl]
        if torch.equal(cm, c):
            cm = c
        p0, x0, m = max(0, -f), max(0, f), max(n2 * n1 - abs(f), 0)
        terms.append((p0, m, x0, cm.reshape(B, -1).narrow(1, p0, m)))
    return terms


def _apply2d(terms, x):
    """Batched 2-D stencil matvec of the `_plane_terms` on x [B, n2, n1];
    out-of-grid neighbors are zero (Dirichlet drop).  Each entry adds
    its product, in the entries' order, into one accumulator."""
    B = x.shape[0]
    xf = x.reshape(B, -1)
    acc = torch.zeros(xf.shape, dtype=x.dtype, device=x.device)
    for p0, m, x0, c in terms:
        acc.narrow(1, p0, m).addcmul_(c, xf.narrow(1, x0, m))
    return acc.view(x.shape)


def _line_bands(entries_np):
    """lower/diag/upper of the in-line (d2 == 0) systems."""
    some = next(iter(entries_np.values()))
    z = np.zeros_like(some)
    lo = entries_np.get((0, -1), z)
    di = entries_np.get((0, 0), z)
    up = entries_np.get((0, 1), z)
    return lo, di, up


def _host_entries(entries):
    return {k: np.asarray(v) for k, v in entries.items()}


def _host_entries(entries):
    return {k: np.asarray(v) for k, v in entries.items()}


class BatchedSMG2D:
    """Batched 2-D SMG over B independent planes [B, n2, n1]:
    semicoarsens n2, relaxes with parity line block-GS (exact PCR line
    solves along n1).  `entries`: {(d2, d1): numpy [B, n2, n1]}."""

    def __init__(self, entries, num_pre_relax=1, num_post_relax=1,
                 max_levels=0, *, device="cuda"):
        self.pre = num_pre_relax
        self.post = num_post_relax
        self.levels = []
        self._views = {}
        ent = _host_entries(entries)
        B, n2, n1 = next(iter(ent.values())).shape
        nlev = int(np.log2(max(n2, 1))) + 2
        if max_levels > 0:
            nlev = min(nlev, max_levels)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        for l in range(nlev):
            lo, di, up = _line_bands(ent)
            entries = {k: put(v) for k, v in ent.items()}
            lvl = dict(
                entries=entries,
                terms=_plane_terms(entries),
                # one factor for each parity's lines (rows of n2)
                pcr=tuple(pcr_factor(*(put(np.ascontiguousarray(a[:, p::2]))
                                       for a in (lo, di, up)))
                          for p in (0, 1)),
            )
            n2l = next(iter(ent.values())).shape[1]
            if n2l <= 1 or l == nlev - 1:
                self.levels.append(lvl)
                break
            p_lo, p_hi = self._interp_weights(ent, (lo, di, up))
            lvl["p_lo"] = put(p_lo[:, 1::2])
            lvl["p_hi"] = put(p_hi[:, 1::2])
            self.levels.append(lvl)
            ent = self._rap(ent, p_lo, p_hi)

    # -- setup helpers (host) -------------------------------------------
    @staticmethod
    def _interp_weights(ent, bands):
        """smg_setup_interp.c analog in 2-D: P weight for cdir2 offset o
        solves the line system against -(couplings with d2 == -o),
        in-line shifts masked to the grid."""
        lo, di, up = bands
        B, n2, n1 = di.shape
        i1 = np.arange(n1)
        out = {}
        for o in (-1, 1):
            rhs = np.zeros((B, n2, n1))
            for (d2, d1), c in ent.items():
                if d2 == -o:
                    ok = ((i1 + d1 >= 0) & (i1 + d1 < n1)).astype(float)
                    rhs -= c * ok
            out[o] = _thomas_host(lo, di, up, rhs)
        return out[1], out[-1]  # p_lo, p_hi (lower/upper coarse donor)

    @staticmethod
    def _rap(ent, p_lo, p_hi):
        """Exact per-plane Galerkin RAP, reassembled into batched coarse
        stencil entries (hypre smg2_setup_rap.c role)."""
        B, n2, n1 = next(iter(ent.values())).shape
        n2c = (n2 + 1) // 2
        nf, nc = n2 * n1, n2c * n1
        i2, i1 = np.indices((n2, n1))
        row = (i2 * n1 + i1).ravel()

        out_entries = {}
        for b in range(B):
            rows_l, cols_l, vals_l = [], [], []
            for (d2, d1), c in ent.items():
                j2, j1 = i2 + d2, i1 + d1
                ok = (j2 >= 0) & (j2 < n2) & (j1 >= 0) & (j1 < n1)
                rows_l.append(row[ok.ravel()])
                cols_l.append((j2[ok] * n1 + j1[ok]).ravel())
                vals_l.append(c[b][ok])
            A2 = sp.coo_matrix(
                (np.concatenate(vals_l),
                 (np.concatenate(rows_l), np.concatenate(cols_l))),
                shape=(nf, nf),
            ).tocsr()
            # P: coarse (J, i1) -> fine rows 2J (identity), 2J+-1 (weights)
            pr, pc, pv = [], [], []
            J2, J1 = np.indices((n2c, n1))
            crow = (J2 * n1 + J1).ravel()
            pr.append((2 * J2 * n1 + J1).ravel()); pc.append(crow)
            pv.append(np.ones(nc))
            odd2, odd1 = np.indices(((n2 - 1) // 2 + (n2 % 2 == 0), n1))
            f2 = 2 * odd2 + 1
            frow = (f2 * n1 + odd1).ravel()
            pr.append(frow); pc.append((odd2 * n1 + odd1).ravel())
            pv.append(p_lo[b][1::2].ravel())
            hi_ok = odd2 + 1 < n2c
            pr.append(frow[hi_ok.ravel()])
            pc.append(((odd2 + 1) * n1 + odd1)[hi_ok].ravel())
            pv.append(p_hi[b][1::2][hi_ok])
            P = sp.coo_matrix(
                (np.concatenate(pv), (np.concatenate(pr), np.concatenate(pc))),
                shape=(nf, nc),
            ).tocsr()
            C = (P.T @ A2 @ P).tocoo()
            C.sum_duplicates()
            r2, r1 = C.row // n1, C.row % n1
            c2, c1 = C.col // n1, C.col % n1
            d2a, d1a = c2 - r2, c1 - r1
            key_all = d2a * 8 + d1a  # |d1| <= 2 so this is injective
            for key in np.unique(key_all):
                m = key_all == key
                d2 = int(d2a[m][0])
                d1 = int(d1a[m][0])
                arr = out_entries.setdefault(
                    (d2, d1), np.zeros((B, n2c, n1))
                )
                arr[b][r2[m], r1[m]] = C.data[m]
        return out_entries

    # -- solve (device) --------------------------------------------------
    def _batch(self, batch):
        """The levels with every tensor restricted to the planes `batch`
        (None: all; a slice: contiguous copies, kept)."""
        if batch is None:
            return self.levels
        key = (batch.start, batch.stop, batch.step)
        if key not in self._views:
            self._views[key] = self._cut_levels(
                lambda t: t[batch].contiguous())
        return self._views[key]

    def _cut_levels(self, cut) -> list:
        """The solve's tensors of every level, each through `cut`."""
        views = []
        for lvl in self.levels:
            v = {"terms": [(p0, m, x0, cut(c))
                           for p0, m, x0, c in lvl["terms"]],
                 "pcr": tuple(([(k, cut(a), cut(g)) for k, a, g in sw],
                               cut(b)) for sw, b in lvl["pcr"])}
            for k in ("p_lo", "p_hi"):
                if k in lvl:
                    v[k] = cut(lvl[k])
            views.append(v)
        return views

    def cut(self, planes: slice, device) -> "BatchedSMG2D":
        """The same solver on the planes `planes` only, on `device` (a
        shard's own planes under a sharded 3-D SMG)."""
        new = BatchedSMG2D.__new__(BatchedSMG2D)
        new.pre, new.post, new._views = self.pre, self.post, {}
        new.levels = self._cut_levels(
            lambda t: t[planes].contiguous().to(device))
        return new

    @staticmethod
    def _line_update(lvl, x, b, parity):
        """Solve the `parity` lines (rows of n2) exactly against the
        current residual; the other rows keep their values."""
        r = b - _apply2d(lvl["terms"], x)
        x = x.clone()
        if parity < x.shape[1]:
            sel = (slice(None), slice(parity, None, 2))
            x[sel] += pcr_apply(lvl["pcr"][parity], r[sel])
        return x

    def _relax(self, lvl, x, b, sweeps, up=False):
        order = (1, 0) if up else (0, 1)
        for _ in range(sweeps):
            for par in order:
                x = self._line_update(lvl, x, b, par)
        return x

    @staticmethod
    def _restrict(lvl, r):
        return semi_restrict(r, 1, lvl["p_lo"], lvl["p_hi"])

    @staticmethod
    def _interp_add(lvl, x, ec):
        return semi_interp_add(x, 1, lvl["p_lo"], lvl["p_hi"], ec)

    def _vcycle(self, levels, l, b):
        lvl = levels[l]
        if l == len(levels) - 1:
            x = self._line_update(lvl, torch.zeros_like(b), b, 0)
            return self._line_update(lvl, x, b, 1)
        x = self._relax(lvl, torch.zeros_like(b), b, self.pre)
        r = b - _apply2d(lvl["terms"], x)
        ec = self._vcycle(levels, l + 1, self._restrict(lvl, r))
        x = self._interp_add(lvl, x, ec)
        return self._relax(lvl, x, b, self.post, up=True)

    def solve(self, b, cycles: int = 1, batch=None):
        """Approximate plane solves: `cycles` V-cycles, zero guess
        (hypre runs one V-cycle per relax; setup uses a few).  `batch`:
        the planes b holds (a slice of the B planes; None: all)."""
        levels = self._batch(batch)
        x = self._vcycle(levels, 0, b)
        for _ in range(cycles - 1):
            r = b - _apply2d(levels[0]["terms"], x)
            x = x + self._vcycle(levels, 0, r)
        return x
