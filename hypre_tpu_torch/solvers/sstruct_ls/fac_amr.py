"""Faithful FAC for semi-structured AMR composites (sstruct_fac solver 99;
port of hypre_tpu/solvers/sstruct_ls/fac_amr.py).

Reference pipeline replicated here, file by file:

- driver zeroing (test/sstruct_fac.c:1695-1712): `HYPRE_SStructFACZeroCFSten`
  (coarse legs reaching under the patch -> 0, fac_zero_stencilcoef.c:33),
  `...ZeroFCSten` (fine legs leaving the patch -> 0, :217),
  `...ZeroAMRMatrixData` (covered coarse rows -> identity,
  fac_amr_zero_data.c:161), `...ZeroAMRVectorData` (b, x -> 0 under
  patches, :16).
- `hypre_AMR_RAP` (fac_amr_rap.c:23): per level finest->1,
  `hypre_AMR_CFCoarsen` (fac_cf_coarsen.c:100 — collapse the coarse
  interface rows' unstructured couplings into stencil legs, row-sum
  preserving) then `hypre_AMR_FCoarsen` (fac_amr_fcoarsen.c:66 — coarse
  operator under the patch: face-averaged stencil legs with trilinear
  weights {1, .25, .125, .0625} (:143), centre = scaled agglomerate
  row-sum minus legs (:1936-1978, :2106-2320), interface legs from
  arithmetically averaged fine-to-coarse couplings (:2700-3370), final
  centre adjustment (:3415-3490)).
- level solves (fac_solve3.c): two-part composites, SysPFMG red-black
  Gauss-Seidel relaxation on the patch (fac_relax.c; red = odd global
  parity first, sys_pfmg_relax.c:120-145), fullweighted restriction
  sum/rfactor[0]^(ndim-2) under the patch + injection elsewhere
  (fac_restrict2.c:583-800), identity + cell-centred trilinear
  interpolation (fac_interp2.c:633-660 weight table), coarsest solve =
  ONE SysPFMG V(1,1) cycle on part 0 (fac_setup2.c:926-943).

The setup (`_build_parts`, `_driver_zero`, `_amr_rap` with
`_cf_coarsen` / `_f_coarsen`, the coarsest SysPFMG's `_coarsen`) is the
JAX package's host numpy, line for line: the same per-part stencil
arrays, U couplings and hierarchy, bit for bit.  The solve runs on
torch tensors on the solver's device: `PartOp.matvec` (one `addcmul_`
an offset on the slices it reaches), `rb_relax` / `wjacobi_relax` with
the parity masks and inverse diagonals frozen there, the U couplings as
one `index_add_` a part pair, the restriction and the trilinear
interpolation from index / weight tables built at setup, and the
coarsest SysPFMG's transfers frozen by `freeze_auto` (dense or the ELL
kernel on the card).  `solve` reads the composite residual's squared
norm on the host once an iteration.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix
from ...ops.dia import freeze_auto, spmv
from ...sstruct.infile import ProblemData
from ...struct.matrix import _reach
from ..krylov.common import SolverResult
from ..struct_ls.pfmg import _collapse_interp, _compute_dxyz

_W_ABS = np.array([1.0, 0.25, 0.125, 0.0625])  # fac_amr_fcoarsen.c:143


# ---------------------------------------------------------------------------
# dense per-part stencil operator
# ---------------------------------------------------------------------------
class PartOp:
    """Stencil operator on one part's box: coef[S, *shape] (host numpy,
    what the setup reads and writes), global ilo.  `device` (None: a
    host-only operator of the setup) gets the coefficients, the inverse
    diagonal and the red mask as tensors, for the solve."""

    def __init__(self, ilo, shape, offsets, coef, device=None):
        self.ilo = tuple(int(x) for x in ilo)
        self.shape = tuple(int(x) for x in shape)
        self.offsets = [tuple(int(x) for x in o) for o in offsets]
        self.coef = coef  # [S, *shape]
        self.nd = len(self.shape)
        self.device = None if device is None else torch.device(device)
        if self.device is not None:
            put = lambda a: torch.from_numpy(  # noqa: E731
                np.ascontiguousarray(a)).to(self.device)
            diag = self.diag_entry()
            self.coef_t = put(coef)
            self.dinv_t = put(np.where(
                diag == 0, 0.0, 1.0 / np.where(diag == 0, 1.0, diag)))
            self.red_t = put(self.parity() == 1)

    def _shift(self, x, off):
        """x sampled at cell+off with zero ghosts (host numpy)."""
        out = np.zeros_like(x)
        dst, src = _reach(off, self.shape, (0,) * self.nd)
        out[dst] = x[src]
        return out

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.zeros_like(x)
        for k, off in enumerate(self.offsets):
            dst, src = _reach(off, self.shape, (0,) * self.nd)
            y[dst].addcmul_(self.coef_t[k][dst], x[src])
        return y

    def diag_entry(self):
        return self.coef[self.offsets.index((0,) * self.nd)]

    def parity(self):
        """(i+j+k) mod 2 in GLOBAL index space (node_relax nodesets)."""
        idx = sum(
            np.meshgrid(
                *[np.arange(s) + self.ilo[d] for d, s in enumerate(self.shape)],
                indexing="ij",
            )
        )
        return idx % 2

    def rb_relax(self, x, b, sweeps, red_first=True):
        """Red-black GS; red = odd global parity (sys_pfmg_relax.c:130)."""
        red = self.red_t
        order = [red, ~red] if red_first else [~red, red]
        for _ in range(int(sweeps)):
            for mask in order:
                r = b - self.matvec(x)
                x = torch.where(mask, x + self.dinv_t * r, x)
        return x

    def wjacobi_relax(self, x, b, sweeps, w=1.0):
        for _ in range(int(sweeps)):
            x = x + w * self.dinv_t * (b - self.matvec(x))
        return x


class _HostStencil:
    """The stencil view `_compute_dxyz` / `_collapse_interp` read
    (.data, .offsets, .diagonal() as CPU tensors), over a PartOp's host
    arrays, without copying them."""

    def __init__(self, op: "PartOp"):
        self.data = torch.from_numpy(op.coef)
        self.offsets = list(op.offsets)
        self._diag = torch.from_numpy(
            op.coef[op.offsets.index((0,) * op.nd)])

    def diagonal(self):
        return self._diag


# ---------------------------------------------------------------------------
# origin-aware single-variable PFMG (the FAC coarsest-level SysPFMG)
# ---------------------------------------------------------------------------
class _OriginPFMG:
    """SysPFMG for nvars=1 with correct GLOBAL index-space coarsening:
    coarse points are globally-even planes (cindex 0, stride 2,
    sys_pfmg_setup.c:295-300), red-black relax with global parity, the
    skip-relax active flags, and hypre's coarsest Jacobi sweep count.
    `levels` holds the host hierarchy (op, cdir, active, P); each
    level's operator and P, P^T live on `device` for the cycle."""

    def __init__(self, op: PartOp, num_pre=1, num_post=1, *, device):
        self.num_pre = num_pre
        self.num_post = num_post
        self.device = dev = torch.device(device)
        nd = op.nd
        dxyz, dxyz_flag = _compute_dxyz(_HostStencil(op))

        self.levels = []  # (op, cdir, active, P)
        A = op
        coarsen = np.ones(3, dtype=bool)
        max_levels = 1 + sum(int(np.log2(max(s, 1))) + 2 for s in op.shape)
        for l in range(max_levels):
            min_d = dxyz[0] + dxyz[1] + dxyz[2] + 1
            cdir = -1
            for d in range(nd):
                if A.shape[d] > 1 and dxyz[d] < min_d:
                    min_d = dxyz[d]
                    cdir = d
            if l == max_levels - 1:
                cdir = -1
            if cdir == -1:
                self.levels.append((A, -1, True, None))
                self.cmaxsize = max(A.shape)
                break
            active = bool(coarsen[cdir])
            if active:
                coarsen[:] = False
            coarsen[cdir] = True
            P, Ac = self._coarsen(A, cdir)
            self.levels.append((A, cdir, active, P))
            dxyz[cdir] *= 2
            A = Ac
        self.coarse_maxiter = min(4 * len(self.levels), self.cmaxsize)
        # the device side: each level's operator, P and P^T
        self._ops = [PartOp(A.ilo, A.shape, A.offsets, A.coef, dev)
                     for A, _, _, _ in self.levels]
        self._P = [None if P is None else freeze_auto(
            CSRMatrix.from_scipy(P), torch.float64, dev)
            for _, _, _, P in self.levels]
        self._PT = [None if P is None else freeze_auto(
            CSRMatrix.from_scipy(P.T.tocsr()), torch.float64, dev)
            for _, _, _, P in self.levels]

    @staticmethod
    def _coarsen(A: PartOp, cdir):
        """P by stencil collapse at odd-GLOBAL planes (cindex 0, stride 2)
        and the semi-RAP coarse operator.

        Faithfulness detail (hypre_SemiBuildRAP, struct_ls/semi_setup_rap.c):
        hypre evaluates the RAP stencil formulas with POINTWISE data reads
        and NO bounds checks on the coarse target.  Two consequences for
        boundary rows:

        - P weights at real fine cells contribute even when their coarse
          TARGET lies outside the grid -> boundary legs along cdir.
        - paths whose RA leg lands on a C point "stay" there with implicit
          weight 1 (semi_setup_rap.c:122-128) even when that C point lies
          outside the grid TRANSVERSALLY, so the stored fine boundary legs
          (e.g. the -1 Laplacian legs pointing out of the domain) survive
          into the coarse coefficient arrays as transverse boundary legs.

        Neither kind of leg ever enters a matvec (ghost x is zero) but
        both feed the next level's stencil-collapse interpolation
        weights, which changes the hierarchy and hence iteration counts.
        We reproduce the pointwise semantics exactly with an extended
        Galerkin product: fine/coarse index spaces get ghost zones on
        EVERY axis, ghost C cells get identity entries in the right-hand
        P (the weight-1 rule; ghost F cells read hypre's zeroed P ghost
        storage, i.e. nothing), and the ghost-column entries of
        P_left^T A_ext P_right are folded back as boundary legs."""
        nd = A.nd
        p_lo, p_hi = _collapse_interp(_HostStencil(A), cdir)

        lo_g = A.ilo[cdir]
        n = A.shape[cdir]
        gidx = np.arange(n) + lo_g
        even_local = np.flatnonzero(gidx % 2 == 0)  # coarse planes
        c_lo = int(gidx[even_local][0] // 2)
        nc = len(even_local)

        cshape = list(A.shape)
        cshape[cdir] = nc
        cilo = list(A.ilo)
        cilo[cdir] = c_lo

        # ghost widths: fine = max |A offset| per axis; coarse = same
        # (covers both P targets along cdir and transverse C-cell targets)
        gw = [max([abs(o[d]) for o in A.offsets] + [1]) for d in range(nd)]
        fshape_e = [A.shape[d] + 2 * gw[d] for d in range(nd)]
        cshape_e = [cshape[d] + 2 * gw[d] for d in range(nd)]

        # ---- extended fine cell bookkeeping -------------------------------
        grids_e = np.indices(fshape_e)  # extended-local coords
        glob = [grids_e[d] - gw[d] + A.ilo[d] for d in range(nd)]
        is_real = np.ones(fshape_e, bool)
        for d in range(nd):
            loc = grids_e[d] - gw[d]
            is_real &= (loc >= 0) & (loc < A.shape[d])
        is_C = (glob[cdir] % 2) == 0

        def coarse_ecol(g):
            """extended coarse linear index of the coarse image of global
            fine coords g (list of arrays); cdir assumed even."""
            loc = []
            for d in range(nd):
                if d == cdir:
                    loc.append(g[d] // 2 - c_lo + gw[d])
                else:
                    loc.append(g[d] - A.ilo[d] + gw[d])
            return np.ravel_multi_index(loc, cshape_e)

        # ---- P_right: extended fine -> extended coarse --------------------
        # C cells (real AND ghost): identity; real F cells: p_lo/p_hi.
        rows_l, cols_l, vals_l = [], [], []
        lin_e = np.ravel_multi_index(grids_e, fshape_e)
        cm = is_C.ravel()
        rows_l.append(lin_e.ravel()[cm])
        cols_l.append(coarse_ecol(glob).ravel()[cm])
        vals_l.append(np.ones(int(cm.sum())))

        fm = (~is_C & is_real).ravel()
        lin_f = lin_e.ravel()[fm]
        glob_f = [g.ravel()[fm] for g in glob]
        real_sl = tuple(slice(gw[d], gw[d] + A.shape[d]) for d in range(nd))
        for w, sgn in ((p_lo, -1), (p_hi, +1)):
            g2 = [g.copy() for g in glob_f]
            g2[cdir] = g2[cdir] + sgn  # even neighbour along cdir
            w_e = np.zeros(fshape_e)
            w_e[real_sl] = w
            rows_l.append(lin_f)
            cols_l.append(coarse_ecol(g2))
            vals_l.append(w_e.ravel()[fm])

        me_f = int(np.prod(fshape_e))
        me_c = int(np.prod(cshape_e))
        Pr = sp.coo_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(me_f, me_c),
        ).tocsr()

        # ---- P_left = P_right restricted to REAL fine rows ----------------
        Pl = Pr[is_real.ravel()]  # (nreal x me_c), row order = real raveling

        # ---- A_ext: real fine rows x extended fine cols -------------------
        nfull = int(np.prod(A.shape))
        rows_a, cols_a, vals_a = [], [], []
        grids_r = np.indices(A.shape)
        rows_real = np.ravel_multi_index(grids_r, A.shape).ravel()
        for k, off in enumerate(A.offsets):
            tgt = [grids_r[d] + gw[d] + off[d] for d in range(nd)]
            rows_a.append(rows_real)
            cols_a.append(np.ravel_multi_index(tgt, fshape_e).ravel())
            vals_a.append(A.coef[k].ravel())
        Ae = sp.coo_matrix(
            (np.concatenate(vals_a),
             (np.concatenate(rows_a), np.concatenate(cols_a))),
            shape=(nfull, me_f),
        ).tocsr()

        Ac_e = (Pl.T @ Ae @ Pr).tocoo()

        # fold extended-space entries into stencil coefficient arrays,
        # keeping only REAL rows (ghost coarse rows are never stored)
        rmi = np.array(np.unravel_index(Ac_e.row, cshape_e))
        cmi = np.array(np.unravel_index(Ac_e.col, cshape_e))
        for d in range(nd):
            rmi[d] -= gw[d]
            cmi[d] -= gw[d]
        real = np.ones(rmi.shape[1], bool)
        for d in range(nd):
            real &= (rmi[d] >= 0) & (rmi[d] < cshape[d])
        offs_arr = (cmi - rmi)[:, real]
        rmi = rmi[:, real]
        data = Ac_e.data[real]
        uniq = sorted({tuple(int(x) for x in offs_arr[:, i])
                       for i in range(offs_arr.shape[1])})
        coef = np.zeros((len(uniq),) + tuple(cshape))
        key = {o: k for k, o in enumerate(uniq)}
        for i in range(offs_arr.shape[1]):
            o = tuple(int(x) for x in offs_arr[:, i])
            coef[(key[o],) + tuple(rmi[:, i])] += data[i]

        # the matvec-facing P: real fine rows x real coarse cols
        keep = np.zeros(cshape_e, bool)
        keep[tuple(slice(gw[d], gw[d] + cshape[d]) for d in range(nd))] = True
        P = Pl[:, keep.ravel()]

        Ac = PartOp(cilo, cshape, uniq, coef)
        return P, Ac

    def _vcycle(self, l, b):
        A, cdir, active, _ = self.levels[l]
        op = self._ops[l]
        if l == len(self.levels) - 1:
            # coarsest: w=1 Jacobi, min(4*levels, cmaxsize) sweeps, 0-guess
            return op.wjacobi_relax(torch.zeros_like(b), b, self.coarse_maxiter)
        if active:
            x = op.rb_relax(torch.zeros_like(b), b, self.num_pre,
                            red_first=True)
            r = b - op.matvec(x)
        else:
            x = torch.zeros_like(b)
            r = b
        bc = spmv(self._PT[l], r.reshape(-1)).reshape(
            self.levels[l + 1][0].shape)
        ec = self._vcycle(l + 1, bc)
        x = x + spmv(self._P[l], ec.reshape(-1)).reshape(A.shape)
        if active:
            x = op.rb_relax(x, b, self.num_post, red_first=False)
        return x

    def cycle(self, b):
        """One SysPFMG iteration, zero guess (the FAC csolver_type=2)."""
        return self._vcycle(0, b)


# ---------------------------------------------------------------------------
# the FAC solver proper
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FACAMROptions:
    tol: float = 1e-6
    max_iter: int = 20
    relax_type: int = 2
    num_pre: int = -1   # -1: driver default rfactor[finest][0]-1
    num_post: int = -1


class FACAMRSolver:
    def __init__(self, data: ProblemData, opts: FACAMROptions = None, *,
                 device="cuda"):
        """Host setup; the level operators, U couplings, transfer tables
        and the coarsest SysPFMG live on `device`, where `solve` runs."""
        self.opts = opts or FACAMROptions()
        self.data = data
        self.device = torch.device(device)
        nd = data.ndim
        self.nd = nd
        self.nparts = data.nparts

        # FacParts: plevels / rfactors (sstruct_fac.c:619-624)
        self.rfactors = {}
        for p, (plev, rf) in getattr(data, "fac_parts", {}).items():
            self.rfactors[p] = tuple(rf[:nd]) + (1,) * (3 - nd)
        if not self.rfactors:
            self.rfactors = {
                p: ((1,) * 3 if p == 0 else (2,) * nd + (1,) * (3 - nd))
                for p in range(self.nparts)
            }
        o = self.opts
        rf_fin = self.rfactors[self.nparts - 1]
        if o.num_pre < 0:
            o.num_pre = rf_fin[0] - 1  # sstruct_fac.c:1510
        if o.num_post < 0:
            o.num_post = rf_fin[0] - 1

        self._build_parts()
        self._driver_zero()
        self._amr_rap()
        self._setup_levels()

    # ------------------------------------------------------------------
    def _build_parts(self):
        """Per-part dense stencil coefs + U couplings (cell var only)."""
        data = self.data
        nd = self.nd
        self.ilo = {}
        self.shape = {}
        self.offsets = {}
        self.coef = {}
        for p in range(self.nparts):
            lo_pi, up_pi = data.extents[p]
            lo = tuple(lo_pi.point()[:nd])
            up = tuple(up_pi.point()[:nd])
            shape = tuple(up[d] - lo[d] + 1 for d in range(nd))
            self.ilo[p] = lo
            self.shape[p] = shape
            sid = data.part_stencil[(p, 0)]
            ents = data.stencils[sid]
            offs = [tuple(e[0][:nd]) for e in ents]
            coef = np.zeros((len(offs),) + shape)
            for k, (off, var, val) in enumerate(ents):
                coef[k] = val
            self.offsets[p] = offs
            self.coef[p] = coef

        # MatrixSet/AddToValues boxes
        for box, is_set in itertools.chain(
            ((b, True) for b in data.matset), ((b, False) for b in data.matadd)
        ):
            p = box.part
            if box.entry >= len(self.offsets[p]):
                continue
            lo = box.ilower.point()[:nd]
            up = box.iupper.point()[:nd]
            sl = tuple(
                slice(lo[d] - self.ilo[p][d], up[d] - self.ilo[p][d] + 1,
                      box.stride[d])
                for d in range(nd)
            )
            if is_set:
                self.coef[p][box.entry][sl] = box.value
            else:
                self.coef[p][box.entry][sl] += box.value

        # U couplings: (part, global idx tuple, to_part, to global idx, value)
        #
        # Faithful ENTRY-SLOT semantics of the reference FAC driver: the
        # graph is built first (AddEntries appends one U slot per call, in
        # file-line order per row — sstruct_fac.c:1535-1558), then values
        # are set addressing slots by the LINE's entry number minus the
        # stencil size (sstruct_fac.c:1613-1634 -> sstruct_matrix.c:878-888
        # `entry -= size; col = UVEntryToRank(Uventry, entry)`), last
        # write wins.  When a row is touched by lines whose entry numbers
        # collide (e.g. a patch-corner cell with one fine-to-coarse line,
        # entry 7 value -1, AND four coarse-to-fine lines, entries 7-10
        # value -.25), slot 7's value is OVERWRITTEN and the row's last
        # slot never receives a value (stays 0).  This is observable in
        # the assembled oracle matrix and affects iteration counts
        # (5lev -r 1 5 1: 16 vs 15 without it).
        add_order = {}  # (part, cell) -> [(to_part, to_cell), ...]
        slot_vals = {}  # (part, cell) -> {slot: value}
        for g in data.graph_entries:
            S = len(data.stencils[data.part_stencil[(g.part, g.var)]])
            lo = g.ilower.point()
            up = g.iupper.point()
            ranges = [
                range(lo[d], up[d] + 1, g.stride[d]) for d in range(3)
            ]
            for idx2 in (ranges[2] if nd > 2 else [0]):
                for idx1 in (ranges[1] if nd > 1 else [0]):
                    for idx0 in ranges[0]:
                        index = [idx0, idx1, idx2]
                        to_index = [0, 0, 0]
                        for d in range(3):
                            j = g.index_map[d]
                            k = (index[d] - lo[d]) // g.stride[d]
                            k *= g.index_sign[d]
                            to_index[j] = g.to_ilower.idx[j] + k * g.to_stride[d]
                        key = (g.part, tuple(index[:nd]))
                        add_order.setdefault(key, []).append(
                            (g.to_part, tuple(to_index[:nd]))
                        )
                        slot_vals.setdefault(key, {})[g.entry - S] = g.value
        self.U = []
        for key, lst in add_order.items():
            p, idx = key
            for slot, v in sorted(slot_vals.get(key, {}).items()):
                if 0 <= slot < len(lst):
                    q, tdx = lst[slot]
                    self.U.append((p, idx, q, tdx, v))

        # covered masks: part p cells under patch p+1 (coarsened extents)
        self.covered = {}
        for p in range(self.nparts):
            cov = np.zeros(self.shape[p], bool)
            if p + 1 < self.nparts:
                rf = self.rfactors[p + 1]
                flo = self.ilo[p + 1]
                fshape = self.shape[p + 1]
                # contract to rfactor alignment then floor-map (CF_StenBox)
                clo = []
                cup = []
                for d in range(nd):
                    a = flo[d]
                    rem = a % rf[d]
                    if rem:
                        a += rf[d] - rem
                    clo.append(a // rf[d])
                    cup.append((flo[d] + fshape[d] - 1) // rf[d])
                sl = tuple(
                    slice(clo[d] - self.ilo[p][d], cup[d] - self.ilo[p][d] + 1)
                    for d in range(nd)
                )
                cov[sl] = True
            self.covered[p] = cov
        # per-part U grouped by (row part -> col part)
        self.U_by = {}
        for (p, idx, q, tdx, v) in self.U:
            self.U_by.setdefault((p, q), []).append((idx, tdx, v))

    def _loc(self, p, gidx):
        return tuple(gidx[d] - self.ilo[p][d] for d in range(self.nd))

    def _inbox(self, p, gidx):
        return all(
            0 <= gidx[d] - self.ilo[p][d] < self.shape[p][d]
            for d in range(self.nd)
        )

    # ------------------------------------------------------------------
    def _driver_zero(self):
        """sstruct_fac.c:1695-1712 + rhs/x zeroing."""
        nd = self.nd
        for p in range(self.nparts - 1, 0, -1):
            # ZeroFCSten: fine legs leaving the part box
            for k, off in enumerate(self.offsets[p]):
                if off == (0,) * nd:
                    continue
                mask = np.zeros(self.shape[p], bool)
                # cells x with x+off outside the box
                for d in range(nd):
                    if off[d] > 0:
                        sl = [slice(None)] * nd
                        sl[d] = slice(self.shape[p][d] - off[d], None)
                        mask[tuple(sl)] = True
                    elif off[d] < 0:
                        sl = [slice(None)] * nd
                        sl[d] = slice(0, -off[d])
                        mask[tuple(sl)] = True
                self.coef[p][k][mask] = 0.0

            # ZeroCFSten on part p-1: legs landing in the covered region
            cov = self.covered[p - 1]
            for k, off in enumerate(self.offsets[p - 1]):
                if off == (0,) * nd:
                    continue
                shifted_cov = PartOp(
                    self.ilo[p - 1], self.shape[p - 1], self.offsets[p - 1],
                    np.zeros((1,) + self.shape[p - 1])
                )._shift(cov.astype(float), off) > 0.5
                mask = shifted_cov & ~cov
                self.coef[p - 1][k][mask] = 0.0

            # ZeroAMRMatrixData: covered rows -> identity
            for k, off in enumerate(self.offsets[p - 1]):
                if off == (0,) * nd:
                    self.coef[p - 1][k][cov] = 1.0
                else:
                    self.coef[p - 1][k][cov] = 0.0

    # ------------------------------------------------------------------
    def _amr_rap(self):
        """hypre_AMR_RAP: CFCoarsen + FCoarsen, finest part down to 1."""
        nd = self.nd
        self.rap = {p: self.coef[p].copy() for p in range(self.nparts)}
        for p in range(self.nparts - 1, 0, -1):
            self._cf_coarsen(p)
            self._f_coarsen(p)

    def _cf_coarsen(self, p):
        """fac_cf_coarsen.c STEP 1 on part p-1 rows at the interface."""
        nd = self.nd
        rf = self.rfactors[p]
        offs = self.offsets[p - 1]
        centre = offs.index((0,) * nd)
        cov = self.covered[p - 1]
        coef = self.rap[p - 1]

        # group coarse-row U couplings (p-1 -> p) by row cell
        by_row = {}
        for (idx, tdx, v) in self.U_by.get((p - 1, p), []):
            by_row.setdefault(idx, []).append((tdx, v))

        for gidx, ents in by_row.items():
            loc = self._loc(p - 1, gidx)
            if cov[loc]:
                continue
            # centre += sum of off-centre entries (fac_cf_coarsen.c:344-350)
            row_off_sum = sum(
                coef[k][loc] for k in range(len(offs)) if k != centre
            )
            c = coef[centre][loc] + row_off_sum
            # per coupling: coarsen target index, find stencil direction
            for (tdx, v) in ents:
                cdx = tuple(tdx[d] // rf[d] for d in range(nd))
                dirn = tuple(cdx[d] - gidx[d] for d in range(nd))
                if dirn in offs:
                    k = offs.index(dirn)
                    coef[k][loc] = 0.0
            for (tdx, v) in ents:
                c += v
            for (tdx, v) in ents:
                cdx = tuple(tdx[d] // rf[d] for d in range(nd))
                dirn = tuple(cdx[d] - gidx[d] for d in range(nd))
                if dirn in offs:
                    k = offs.index(dirn)
                    coef[k][loc] += v
            # centre -= new off-centre sum
            c -= sum(coef[k][loc] for k in range(len(offs)) if k != centre)
            coef[centre][loc] = c

    def _f_coarsen(self, p):
        """fac_amr_fcoarsen.c: coarse operator under the patch of part p,
        written into rap[p-1]."""
        nd = self.nd
        rf = self.rfactors[p]
        offs_f = self.offsets[p]
        offs_c = self.offsets[p - 1]
        centre_c = offs_c.index((0,) * nd)
        fine = self.rap[p]
        scaling = float(rf[0]) ** max(nd - 2, 0)

        # coarsened patch extents on part p-1 (aligned boxes)
        cov = self.covered[p - 1]
        cl = [int(i.min()) for i in np.nonzero(cov)]
        cu = [int(i.max()) for i in np.nonzero(cov)]
        csize = [cu[d] - cl[d] + 1 for d in range(nd)]

        # fine local start of the agglomerates
        f0 = [
            (cl[d] + self.ilo[p - 1][d]) * rf[d] - self.ilo[p][d]
            for d in range(nd)
        ]

        def agg_view(arr, sub):
            """arr[f0 + C*rf + sub] as array over coarse cells, for a
            relative fine offset `sub` in [0, rf)^nd."""
            sl = tuple(
                slice(f0[d] + sub[d], f0[d] + sub[d] + csize[d] * rf[d], rf[d])
                for d in range(nd)
            )
            return arr[sl]

        # STEP 1: directional legs by face/edge averaging
        legs = {}  # coarse offset -> array over coarse cells
        for kc, sc in enumerate(offs_c):
            if sc == (0,) * nd:
                continue
            # contribution set: fine entries matching sc on its nonzero axes
            contrib = []
            for kf, sf in enumerate(offs_f):
                if sf == (0,) * nd:
                    continue
                if all(sf[d] == sc[d] for d in range(nd) if sc[d] != 0):
                    contrib.append(kf)
            wts = np.array([
                _W_ABS[sum(abs(x) for x in offs_f[kf])] for kf in contrib
            ])
            wts = wts / wts.sum() if len(wts) else wts
            # shift box: per axis sc=+1 -> [rf-1], -1 -> [0], 0 -> [0..rf)
            ranges = []
            for d in range(nd):
                if sc[d] > 0:
                    ranges.append([rf[d] - 1])
                elif sc[d] < 0:
                    ranges.append([0])
                else:
                    ranges.append(list(range(rf[d])))
            vol = int(np.prod([len(r) for r in ranges]))
            acc = np.zeros(csize)
            for sub in itertools.product(*ranges):
                for m, kf in enumerate(contrib):
                    acc += wts[m] * agg_view(fine[kf], sub)
            legs[sc] = acc / vol

        # centre: scaled agglomerate row sum (structured + fine U couplings)
        rowsum = np.zeros(csize)
        for sub in itertools.product(*[range(rf[d]) for d in range(nd)]):
            for kf in range(len(offs_f)):
                rowsum += agg_view(fine[kf], sub)
        # fine U couplings to part p-1 (interface cells)
        for (idx, tdx, v) in self.U_by.get((p, p - 1), []):
            loc = self._loc(p, idx)
            C = tuple(
                (idx[d] // rf[d]) - (cl[d] + self.ilo[p - 1][d])
                for d in range(nd)
            )
            if all(0 <= C[d] < csize[d] for d in range(nd)):
                rowsum[C] += v
        rowsum /= scaling

        # STEP 2: interface legs from averaged fine-to-coarse couplings
        groups = {}  # coarse node C (local to patch) -> {dir: [vals]}
        for (idx, tdx, v) in self.U_by.get((p, p - 1), []):
            Cg = tuple(idx[d] // rf[d] for d in range(nd))  # global coarse
            C = tuple(Cg[d] - (cl[d] + self.ilo[p - 1][d]) for d in range(nd))
            dirn = tuple(tdx[d] - Cg[d] for d in range(nd))
            groups.setdefault(C, {}).setdefault(dirn, []).append(v)

        iface = {}  # C -> {dir: averaged val}
        for C, dirs in groups.items():
            iface[C] = {d: float(np.mean(vs)) for d, vs in dirs.items()}

        for C, svals in iface.items():
            for kc, sc in enumerate(offs_c):
                if sc == (0,) * nd or sc not in svals and not any(
                    all((dd[a] == sc[a]) for a in range(nd) if sc[a] != 0)
                    for dd in svals
                ):
                    continue
                # collapse set: interface dirs matching sc on nonzero axes
                tot_w = 0.0
                tot = 0.0
                found = False
                for dd, val in svals.items():
                    if all(dd[a] == sc[a] for a in range(nd) if sc[a] != 0):
                        w = _W_ABS[sum(abs(x) for x in dd)]
                        tot_w += w
                        tot += w * val
                        found = True
                if found and sc in svals:
                    legs[sc][C] = tot / tot_w
                elif found:
                    # only non-stencil dirs collapse here (e.g. diagonal
                    # couplings onto a face entry with no direct coupling)
                    legs[sc][C] = tot / tot_w

        # STEP 3 + interior centre: centre = rowsum - sum(legs)
        cen = rowsum.copy()
        for sc, arr in legs.items():
            cen -= arr

        # write into rap[p-1] over the coarsened patch
        out_sl = tuple(slice(cl[d], cu[d] + 1) for d in range(nd))
        for kc, sc in enumerate(offs_c):
            if sc == (0,) * nd:
                self.rap[p - 1][kc][out_sl] = cen
            else:
                self.rap[p - 1][kc][out_sl] = legs[sc]

    # ------------------------------------------------------------------
    def _setup_levels(self):
        nd = self.nd
        L = self.nparts
        dev = self.device
        self.fine_op = {}
        self.crse_op0 = {}  # zeroed-covered coarse ops (up-cycle matvec)
        for l in range(L):
            self.fine_op[l] = PartOp(
                self.ilo[l], self.shape[l], self.offsets[l], self.rap[l], dev
            )
        for l in range(1, L):
            coefz = self.rap[l - 1].copy()
            coefz[:, self.covered[l - 1]] = 0.0
            self.crse_op0[l] = PartOp(
                self.ilo[l - 1], self.shape[l - 1], self.offsets[l - 1], coefz,
                dev
            )
        # composite residual ops (fac_solve3.c:129 matvecs A_in): the
        # DRIVER-ZEROED ORIGINAL composite, not the AMR-RAP one — hypre's
        # outer residual never sees the cf/f-coarsened rows.  Covered rows
        # are identity in A_in with x,b zeroed under patches; zeroing the
        # rows is equivalent.
        self.resid_op = {}
        for p in range(L):
            coefz = self.coef[p].copy()
            coefz[:, self.covered[p]] = 0.0
            self.resid_op[p] = PartOp(
                self.ilo[p], self.shape[p], self.offsets[p], coefz, dev
            )
        # coarsest-level SysPFMG on part 0 (full rap op)
        self.csolver = _OriginPFMG(self.fine_op[0], num_pre=1, num_post=1,
                                   device=dev)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        self.covered_t = {p: put(self.covered[p]) for p in range(L)}
        # U couplings, one (rows, cols, values) table a part pair, in
        # the order the couplings were read
        self._U = {}
        for (p, q), ents in self.U_by.items():
            rows = [np.ravel_multi_index(self._loc(p, i), self.shape[p])
                    for i, _, _ in ents]
            cols = [np.ravel_multi_index(self._loc(q, t), self.shape[q])
                    for _, t, _ in ents]
            self._U[(p, q)] = (put(np.asarray(rows, np.int64)),
                               put(np.asarray(cols, np.int64)),
                               put(np.asarray([v for _, _, v in ents],
                                              np.float64)))
        # the restriction's agglomerate slices and the interpolation's
        # gather tables (fac_restrict2.c, fac_interp2.c), per level
        self._rtab = {}
        self._itab = {}
        for l in range(1, L):
            rf = self.rfactors[l]
            cov = self.covered[l - 1]
            cl = [int(i.min()) for i in np.nonzero(cov)]
            cu = [int(i.max()) for i in np.nonzero(cov)]
            csize = [cu[d] - cl[d] + 1 for d in range(nd)]
            f0 = [(cl[d] + self.ilo[l - 1][d]) * rf[d] - self.ilo[l][d]
                  for d in range(nd)]
            subs = [tuple(slice(f0[d] + s[d], f0[d] + s[d] + csize[d] * rf[d],
                                rf[d]) for d in range(nd))
                    for s in itertools.product(*[range(rf[d])
                                                 for d in range(nd)])]
            self._rtab[l] = (subs, csize, tuple(
                slice(cl[d], cu[d] + 1) for d in range(nd)),
                float(rf[0]) ** max(nd - 2, 0))
            self._itab[l] = [(put(i), put(w), put(v))
                             for i, w, v in self._winterp_tables(l)]

    def _winterp_tables(self, l):
        """fac_interp2 WeightedInterp2's terms: for each corner pick, the
        flat index into the part l-1 vector, the trilinear weight and
        the in-box mask, over part l's box."""
        nd = self.nd
        rf = self.rfactors[l]
        shape = self.shape[l]
        # per-axis: parent coarse index and the (nbr, w_nbr) pair
        axis_terms = []
        for d in range(nd):
            gi = np.arange(shape[d]) + self.ilo[l][d]
            c = gi // rf[d]
            o = gi - c * rf[d]
            r = rf[d]
            tpos = (2 * o + 1)  # 2r * fractional position
            low = tpos < r  # nearer the lower coarse neighbour
            w_self = np.where(low, (r + 2 * o + 1) / (2 * r),
                              (3 * r - 2 * o - 1) / (2 * r))
            nbr = np.where(low, c - 1, c + 1)
            axis_terms.append((c, w_self, nbr, 1.0 - w_self))
        p0 = l - 1
        out = []
        for pick in itertools.product([0, 1], repeat=nd):
            idxs = []
            sel = []
            for d in range(nd):
                c, ws, nbr, wn = axis_terms[d]
                gi = np.where(pick[d] == 0, c, nbr)
                wd = np.where(pick[d] == 0, ws, wn)
                idxs.append(gi - self.ilo[p0][d])
                sel.append(wd)
            W = sel[0].reshape((-1,) + (1,) * (nd - 1))
            for d in range(1, nd):
                W = W * sel[d].reshape(
                    (1,) * d + (-1,) + (1,) * (nd - d - 1))
            # gather with zero ghosts
            grids = np.meshgrid(*idxs, indexing="ij")
            valid = np.ones(shape, bool)
            for d in range(nd):
                valid &= (grids[d] >= 0) & (grids[d] < self.shape[p0][d])
            gc = [np.clip(g, 0, self.shape[p0][d] - 1)
                  for d, g in enumerate(grids)]
            flat = np.ravel_multi_index(gc, self.shape[p0])
            out.append((flat, np.array(np.broadcast_to(W, shape)), valid))
        return out

    # ------------------------------------------------------------------
    def _apply_U(self, dst_part, src_part, x_src):
        """The U couplings dst <- src applied to x_src, on dst's box."""
        out = torch.zeros(self.shape[dst_part], dtype=x_src.dtype,
                          device=x_src.device)
        if (dst_part, src_part) in self._U:
            rows, cols, vals = self._U[(dst_part, src_part)]
            out.view(-1).index_add_(0, rows, vals * x_src.reshape(-1)[cols])
        return out

    def _restrict(self, l, b_fine, b_crse):
        """fac_restrict2: fullweight under the coarsened patch (sum /
        rfactor[0]^(nd-2)), inject b_crse elsewhere."""
        subs, csize, box, scale = self._rtab[l]
        out = b_crse.clone()
        acc = torch.zeros(csize, dtype=b_fine.dtype, device=b_fine.device)
        for sl in subs:
            acc += b_fine[sl]
        acc /= scale
        out[box] = acc
        return out

    def _winterp(self, l, xc):
        """fac_interp2 WeightedInterp2: cell-centred trilinear interp of
        the part l-1 vector xc onto part l's box."""
        out = torch.zeros(self.shape[l], dtype=xc.dtype, device=xc.device)
        xf = xc.reshape(-1)
        for flat, W, valid in self._itab[l]:
            out += torch.where(valid, W * xf[flat], 0.0)
        return out

    # ------------------------------------------------------------------
    def solve(self, b_parts=None, x_parts=None) -> SolverResult:
        """hypre_FACSolve3 (fac_solve3.c:18): b and x default to ones and
        zeros; either may be given per part as arrays or tensors."""
        o = self.opts
        L = self.nparts
        dev = self.device

        def take(v):
            return torch.as_tensor(v, dtype=torch.float64).to(dev).clone()

        if b_parts is None:
            b_parts = {p: np.ones(self.shape[p]) for p in range(L)}
        b = {p: take(b_parts[p]) for p in range(L)}
        # ZeroAMRVectorData on b and x
        for p in range(L):
            b[p][self.covered_t[p]] = 0.0
        x = {p: torch.zeros(self.shape[p], dtype=torch.float64, device=dev)
             for p in range(L)}
        if x_parts is not None:
            x = {p: take(x_parts[p]) for p in range(L)}
            for p in range(L):
                x[p][self.covered_t[p]] = 0.0

        b_dot_b = sum(float((b[p] ** 2).sum()) for p in range(L))
        eps = o.tol ** 2
        norms = []
        num_iterations = 0
        converged = False

        b_lvl = {l: {} for l in range(L)}
        x_lvl = {l: {} for l in range(L)}

        def zeros(p):
            return torch.zeros(self.shape[p], dtype=torch.float64, device=dev)

        for i in range(o.max_iter):
            # composite residual
            tx = {}
            for p in range(L):
                r = b[p] - self.resid_op[p].matvec(x[p])
                for q in range(L):
                    if (p, q) in self.U_by:
                        r -= self._apply_U(p, q, x[q])
                tx[p] = r
            r_dot_r = float(sum((tx[p] ** 2).sum() for p in range(L)))
            norms.append(np.sqrt(r_dot_r))
            if (r_dot_r / b_dot_b < eps) and i > 0:
                converged = True
                break

            # level rhs's
            b_lvl[L - 1]["fine"] = tx[L - 1].clone()
            for l in range(1, L):
                b_lvl[l]["crse"] = tx[l - 1].clone()

            # down cycle
            x_lvl[L - 1] = {"fine": zeros(L - 1), "crse": zeros(L - 2)}
            for l in range(L - 1, 0, -1):
                A = self.fine_op[l]
                xf = A.rb_relax(
                    x_lvl[l]["fine"], b_lvl[l]["fine"], o.num_pre,
                    red_first=True,
                )
                x_lvl[l]["fine"] = xf
                b_lvl[l]["fine"] = b_lvl[l]["fine"] - A.matvec(xf)
                b_lvl[l]["crse"] = b_lvl[l]["crse"] - self._apply_U(
                    l - 1, l, xf)
                tgt = self._restrict(
                    l, b_lvl[l]["fine"], b_lvl[l]["crse"])
                if l > 1:
                    b_lvl[l - 1]["fine"] = tgt
                else:
                    b_lvl[0]["crse"] = tgt
                x_lvl[l - 1] = {
                    "fine": zeros(l - 1),
                    "crse": zeros(l - 2) if l > 1 else zeros(0),
                }

            # coarsest: one SysPFMG V(1,1) on part 0
            xc = self.csolver.cycle(b_lvl[0]["crse"])
            x_lvl[0]["crse"] = xc
            x_lvl[0]["fine"] = xc.clone()

            # up cycle
            for l in range(1, L):
                e_crse = torch.where(
                    self.covered_t[l - 1], 0.0, x_lvl[l - 1]["fine"])
                e_fine = self._winterp(l, x_lvl[l - 1]["fine"])
                x_lvl[l]["crse"] = x_lvl[l]["crse"] + e_crse
                x_lvl[l]["fine"] = x_lvl[l]["fine"] + e_fine
                if o.num_post:
                    A = self.fine_op[l]
                    b_lvl[l]["fine"] = (
                        b_lvl[l]["fine"] - A.matvec(e_fine)
                        - self._apply_U(l, l - 1, e_crse)
                    )
                    b_lvl[l]["crse"] = (
                        b_lvl[l]["crse"]
                        - self.crse_op0[l].matvec(e_crse)
                        - self._apply_U(l - 1, l, e_fine)
                    )
                    txl = A.rb_relax(
                        zeros(l), b_lvl[l]["fine"], o.num_post,
                        red_first=True,
                    )
                    x_lvl[l]["fine"] = x_lvl[l]["fine"] + txl

            # corrections into the composite solution
            x[L - 1] = x[L - 1] + x_lvl[L - 1]["fine"]
            for l in range(1, L):
                x[l - 1] = x[l - 1] + x_lvl[l]["crse"]

            num_iterations = i + 1

        rel = norms[-1] / np.sqrt(b_dot_b)
        return SolverResult(
            x=x,
            num_iterations=num_iterations,
            rel_residual_norm=torch.tensor(rel, dtype=torch.float64,
                                           device=dev),
            converged=converged,
            res_norms=torch.tensor(norms, dtype=torch.float64, device=dev),
        )
