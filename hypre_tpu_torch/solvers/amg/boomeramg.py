"""BoomerAMG: hierarchy setup + V-cycle (port of the host-setup part of
hypre_tpu/solvers/amg/boomeramg.py).

Reference: parcsr_ls/par_amg_setup.c (hypre_BoomerAMGSetup), par_cycle.c
(hypre_BoomerAMGCycle).

Setup is host-side numpy/scipy plus the native C kernels, as in the JAX
package: PMIS coarsening, modified classical or extended+i
interpolation, truncation, Galerkin RAP and the optional non-Galerkin
filter.  Each level is then
frozen into torch tensors on an explicit device, and the V-cycle runs
eagerly on that device.  The fine operator is DIA (its matvec is the
hand-written kernel K1 on CUDA).

With the lattice forms off (embed_level1=False, relocate_level2=False,
collapse_coarse_n=0) coarse levels are ELL or dense.  With the JAX
package's defaults the lattice forms of ops/dia.py apply wherever that
package's gates let them: level 1 is embedded on the fine lattice as
DIA (`_build_embed_level1`; with device_rap, the JAX package's default,
its values come from the device pass of ops/device_rap.py and level-0
R from a device transpose, `_run_device_rap`), deeper levels are
relocated onto compact
cell lattices with parity-factored transfers and exact COO tails
(`_plan_reloc`, `_build_relocated`; needs `lattice_shape`), and the
sub-cycle below the first small level is collapsed into one dense
operator (`_build_coarse_collapse`).  A hierarchy that fails a gate
keeps the plain forms, as in the JAX package.

The port implements the options of the bench protocol (V-cycles,
classical or ext+i interpolation, relax_coarse 0/5/7/18/9), the
smoother family of the JAX package for the down and up sweeps (relax
0/5/7/18 Jacobi, 1-4/6/8/13/14 level-scheduled Gauss-Seidel with omega
and the CF-ordered sweeps of relax_order 1, 15 CG, 16 Chebyshev, 17
FCF-Jacobi), the stationary solve (`solve`, hypre's solver 0) and the
lattice path; every other option must keep its default (the device
setup chain, the offset budgets, grid_relax_type / grid_relax_points):
`check_options` raises NotImplementedError otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ... import native
from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.device_rap import (dia_transpose_device, embedded_rap_device,
                               plan_embedded_rap)
from ...ops.dia import (DENSE_MAX_ROWS, DIA_MAX_OFFSETS, DenseMatrix,
                        DIAMatrix, GatherOp, ScatterOp, build_embedded_dia,
                        build_parity_interp, build_parity_restrict,
                        embedded_offset_count, embedded_offsets,
                        freeze_auto, on_cells,
                        parity_offset_count_plan, relocate_to_cells, spmv,
                        spmv_axpy, spmv_resid, tail_min_count)
from ...utils.timing import timed
from ..krylov.common import SolverResult
from .coarsen import pmis_coarsen
from .interp import classical_interp, extended_i_interp, truncate_interp
from .rap import galerkin_rap, nongalerkin_filter
from .relax import (ChebyData, GSMatrix, build_gs_schedule,
                    cheby_setup, chebyshev, gauss_seidel, jacobi, jacobi_cf)
from .strength import strength_matrix


@dataclasses.dataclass(frozen=True)
class BoomerAMGOptions:
    """The JAX package's BoomerAMGOptions: same field names and
    defaults (see hypre_tpu/solvers/amg/boomeramg.py:68 for what each
    one does).  Which of them the port implements is `check_options`'s
    business."""

    max_levels: int = 25
    max_coarse_size: int = 9
    seq_threshold: int = 0
    strong_threshold: float = 0.25
    max_row_sum: float = 0.9
    coarsen_type: str = "pmis"
    interp_type: str = "classical"
    trunc_factor: float = 0.0
    P_max_elmts: int = 0
    agg_num_levels: int = 0
    agg_P_max_elmts: int = 0
    agg_trunc_factor: float = 0.0
    agg_interp_type: int = 4
    num_paths: int = 1
    num_functions: int = 1
    dof_func: Optional[np.ndarray] = None
    post_interp_type: int = 0
    jacobi_trunc_threshold: float = 0.01
    nodal: int = 0
    nodal_diag: int = 0
    gsmg: int = 0
    num_samples: int = 5
    restrict_type: int = 0
    filter_threshold_r: float = 0.0
    air_neumann_degree: int = -1
    additive: int = -1
    mult_additive: int = -1
    simple: int = -1
    add_last_lvl: int = -1
    add_P_max_elmts: int = 0
    add_trunc_factor: float = 0.0
    add_rlx: int = 18
    add_rlx_wt: float = 1.0
    # non-Galerkin drop tol for coarse levels >= 1 (0 = off); a tuple
    # gives per-level tolerances, the last entry extending deeper
    nongalerkin_tol: object = 0.0
    nongalerkin_lump: str = "diag"
    relax_down: int = 13
    relax_up: int = 14
    relax_coarse: int = 9  # 9 = Gaussian elimination (pinv)
    relax_order: int = 0
    relax_weight: float = 1.0
    level_relax_weights: Optional[tuple] = None
    omega: float = 1.0
    level_omegas: Optional[tuple] = None
    num_sweeps: int = 1
    num_sweeps_down: Optional[int] = None
    num_sweeps_up: Optional[int] = None
    num_sweeps_coarse: Optional[int] = None
    grid_relax_type: Optional[tuple] = None
    grid_relax_points: Optional[tuple] = None
    min_coarse_size: int = 0
    strength_abs: bool = False
    cheby_order: int = 2
    cheby_ratio: float = 0.3
    smooth_type: int = 0
    smooth_num_levels: int = 0
    euclid_domains: int = 4
    euclid_fill: int = 1
    euclid_colored: bool = True
    cycle_type: int = 1
    fcycle: bool = False
    seed: int = 2747
    # vector dtype of the frozen hierarchy; setup math stays float64
    dtype: str = "float64"
    # storage dtype of coarse A and all P/R (the fine A keeps `dtype`);
    # None = dtype
    mat_dtype: Optional[str] = None
    embed_level1: bool = True
    max_embedded_offsets: int = 512
    relocate_level2: bool = True
    lattice_shape: Optional[tuple] = None
    lattice_coeffs: Optional[tuple] = None
    relocate_min_n2: int = 6144
    relocate_max_bytes: int = 3 << 30
    max_relocated_offsets: int = 8192
    relocate_offset_budget: int = 0
    transfer_offset_budget: int = 0
    relocate_lump: str = "diag"
    relocate_tail: bool = True
    collapse_coarse_n: int = 2048
    device_coarsen: bool = False
    device_rap: bool = True
    device_setup: bool = False


# Fields the port implements (values checked below).  device_rap picks
# where the embedded level-1 values are computed (the device pass or the
# host product); without the embedding either value means the same
# thing in both packages.
_IMPLEMENTED = frozenset({
    "max_levels", "max_coarse_size", "strong_threshold", "max_row_sum",
    "coarsen_type", "interp_type", "trunc_factor", "P_max_elmts",
    "nongalerkin_tol", "nongalerkin_lump", "relax_down", "relax_up",
    "relax_coarse", "relax_order", "relax_weight", "level_relax_weights",
    "omega", "level_omegas", "cheby_order", "cheby_ratio", "num_sweeps", "num_sweeps_down", "num_sweeps_up", "num_sweeps_coarse",
    "min_coarse_size", "cycle_type", "seed", "dtype", "mat_dtype",
    "device_rap", "embed_level1", "max_embedded_offsets", "relocate_level2",
    "lattice_shape", "relocate_min_n2", "relocate_max_bytes",
    "max_relocated_offsets", "relocate_tail", "collapse_coarse_n",
})
_JACOBI = (0, 5, 7, 18)
# level-scheduled Gauss-Seidel: 1/2/3/13 forward, 4/14 backward, 6/8 both
_GS_TYPES = (1, 2, 3, 4, 6, 8, 13, 14)
# what the down and up sweeps take: the above, 15 CG, 16 Chebyshev, 17
# FCF-Jacobi (the coarsest level builds no GS schedule: relax_coarse
# keeps _JACOBI and 9)
_UPDOWN = _JACOBI + _GS_TYPES + (15, 16, 17)
# interp_type -> host interpolation (hypre interp_type 0 / 6)
_INTERP = {"classical": classical_interp, "ext+i": extended_i_interp}
# (vector dtype, matrix dtype) pairs; K1 takes exactly these
_DTYPES = {("float64", "float64"), ("float32", "float32"),
           ("float32", "bfloat16")}


def check_options(o: BoomerAMGOptions) -> None:
    """Raise NotImplementedError for any option the port does not
    implement; nothing is silently ignored."""
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if f.name not in _IMPLEMENTED:
            changed = v is not None if f.default is None else v != f.default
            if changed:
                raise NotImplementedError(
                    f"{f.name}={v!r} is not implemented in the port "
                    f"(only the default {f.default!r})")
    checks = (
        ("coarsen_type", o.coarsen_type == "pmis"),
        ("interp_type", o.interp_type in _INTERP),
        ("relax_down", o.relax_down in _UPDOWN),
        ("relax_up", o.relax_up in _UPDOWN),
        ("relax_coarse", o.relax_coarse in _JACOBI + (9,)),
        ("relax_order", o.relax_order in (0, 1)),
        ("cycle_type", o.cycle_type == 1),
        ("nongalerkin_lump", o.nongalerkin_lump in ("diag", "strong")),
        ("mat_dtype", (o.dtype, o.mat_dtype or o.dtype) in _DTYPES),
    )
    for name, ok in checks:
        if not ok:
            raise NotImplementedError(
                f"{name}={getattr(o, name)!r} is not implemented in the port")


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    A: object  # DIAMatrix | ELLMatrix | DenseMatrix | a lattice form
    dinv: torch.Tensor
    l1inv: torch.Tensor
    cmask: torch.Tensor  # bool: CF_marker > 0 (all False on coarsest)
    P: Optional[object]  # None on coarsest
    R: Optional[object]  # P^T
    # on the coarsest level: the dense pinv (a tensor), or the collapsed
    # sub-cycle as an operator (DenseMatrix, or that behind Scatter/Gather)
    coarse_inv: Optional[object]
    # GS sweeps (relax 1-4, 6, 8, 13, 14): a schedule a direction, or a
    # (C, F) pair of them with relax_order 1; None on the coarsest
    gs_fwd: Optional[object] = None
    gs_bwd: Optional[object] = None
    cheby: Optional[ChebyData] = None  # relax 16


class BoomerAMG:
    """Setup once on the host, freeze onto `device`; then `.cycle`, or
    use `.precond` as the PCG preconditioner."""

    def __init__(self, A: CSRMatrix, opts: BoomerAMGOptions = BoomerAMGOptions(),
                 *, device):
        check_options(opts)
        self.opts = opts
        self.device = torch.device(device)
        self.levels: list[AMGLevel] = []
        self._host_A: list[sp.csr_matrix] = []
        self._host_P: list[sp.csr_matrix] = []
        self._cf: list[np.ndarray] = []
        self._reloc_cells: dict = {}  # level -> (cells of its points, ncells)
        # the level-1 Galerkin product before the non-Galerkin filter:
        # the device RAP's plan takes its offsets
        self._host_A1_unf: Optional[sp.csr_matrix] = None
        self._pending_rap: Optional[dict] = None
        self._setup(A)
        self._freeze_hierarchy()

    @classmethod
    def from_levels(cls, levels, opts: BoomerAMGOptions, *, device) -> "BoomerAMG":
        """A solve-phase instance over already frozen levels (for
        example the JAX package's, carried over by
        convert.levels_from_numpy)."""
        check_options(opts)
        self = cls.__new__(cls)
        self.opts = opts
        self.device = torch.device(device)
        self.levels = list(levels)
        self._host_A, self._host_P, self._cf = [], [], []
        self._reloc_cells = {}
        self._host_A1_unf = self._pending_rap = None
        return self

    # ------------------------------------------------------------------
    # setup (host)
    # ------------------------------------------------------------------
    def _setup(self, A0: CSRMatrix) -> None:
        o = self.opts
        A = A0.to_scipy().tocsr()
        A.sort_indices()
        # int32 indices + f64 data: scipy's native currency, which the
        # native kernels take without conversion
        if A.indices.dtype != np.int32 and A.shape[0] < np.iinfo(np.int32).max:
            A = sp.csr_matrix(
                (A.data.astype(np.float64, copy=False),
                 A.indices.astype(np.int32), A.indptr.astype(np.int32)),
                shape=A.shape,
            )
            A.has_sorted_indices = True
        with timed("SETUP"):
            while True:
                n = A.shape[0]
                last = (len(self._host_A) >= o.max_levels - 1
                        or n <= o.max_coarse_size)
                if not last:
                    with timed("STRENGTH"):
                        S = strength_matrix(A, o.strong_threshold, o.max_row_sum)
                    with timed("COARSEN"):
                        cf = pmis_coarsen(S, seed=o.seed)
                    nc = int((cf > 0).sum())
                    if nc == 0 or nc == n or nc < o.min_coarse_size:
                        last = True
                if last:
                    self._host_A.append(A)
                    self._cf.append(np.zeros(n, dtype=np.int64))
                    break
                with timed("INTERP"):
                    P = truncate_interp(_INTERP[o.interp_type](A, S, cf),
                                        o.trunc_factor, o.P_max_elmts)
                with timed("RAP"):
                    Ac = galerkin_rap(A, P)
                    if not self._host_A:
                        self._host_A1_unf = Ac
                    ngt = self._level_ngt(len(self._host_A))
                    if ngt > 0:
                        lump = ("diag" if len(self._host_A) == 0
                                else o.nongalerkin_lump)
                        Ac = nongalerkin_filter(Ac, ngt, lump=lump)
                self._host_A.append(A)
                self._host_P.append(P)
                self._cf.append(cf)
                A = Ac

    def _level_ngt(self, level: int) -> float:
        """Per-level non-Galerkin drop tol; level = index of the fine
        side of the RAP producing level+1."""
        t = self.opts.nongalerkin_tol
        if isinstance(t, (tuple, list, np.ndarray)):
            if len(t) == 0:
                return 0.0
            return float(t[min(level, len(t) - 1)])
        return float(t)

    # ------------------------------------------------------------------
    # freeze (host -> device)
    # ------------------------------------------------------------------
    def _freeze_hierarchy(self) -> None:
        """Plan the lattice embedding / relocation, freeze every level
        once into its final form on the device, run the device RAP where
        the embedding left level-1 A to it, then collapse the coarse
        sub-cycle."""
        L = len(self._host_A)
        cpos0 = self._plan_embed()
        reloc = self._plan_reloc(cpos0) if cpos0 is not None else []
        # forms the lattice build steps replace are never frozen
        skip_A = {1} if cpos0 is not None else set()
        skip_PR = {0} if cpos0 is not None else set()
        for ent in reloc:
            skip_A.add(ent["k"])
            skip_PR.add(ent["k"] - 1)
        with timed("FREEZE", device=self.device):
            for k in range(L):
                coarsest = k == L - 1
                self.levels.append(self._freeze_level(
                    self._host_A[k],
                    None if coarsest else self._host_P[k],
                    None if coarsest else self._cf[k],
                    fine=(k == 0), skip_A=k in skip_A, skip_PR=k in skip_PR,
                ))
            if cpos0 is not None:
                self._build_embed_level1(
                    cpos0, any(ent["k"] == 2 for ent in reloc))
            if reloc:
                self._build_relocated(reloc)
        if self._pending_rap is not None:
            with timed("DEVICE_RAP", device=self.device):
                self._run_device_rap()
        with timed("COLLAPSE", device=self.device):
            self._build_coarse_collapse()

    @staticmethod
    def _l1_norms(A) -> np.ndarray:
        """Row-wise sum of |a_ij|."""
        n = A.shape[0]
        if A.nnz == 0:
            return np.zeros(n)
        starts = np.minimum(A.indptr[:-1], A.nnz - 1)
        red = np.add.reduceat(np.abs(A.data), starts)
        return np.where(np.diff(A.indptr) > 0, red, 0.0)

    @staticmethod
    def _inverses(A) -> tuple[np.ndarray, np.ndarray]:
        """(1 / diagonal, 1 / l1 row norm) of A in f64, 0 where that is 0."""
        diag = A.diagonal()
        dinv = np.where(diag == 0, 0.0, 1.0 / np.where(diag == 0, 1.0, diag))
        l1 = BoomerAMG._l1_norms(A)
        l1inv = np.where(l1 == 0, 0.0, 1.0 / np.where(l1 == 0, 1.0, l1))
        return dinv, l1inv

    def _freeze_compact(self, M):
        """A compact (not lattice) operator in `mat_dtype`."""
        o = self.opts
        return freeze_auto(CSRMatrix.from_scipy(M),
                           torch_dtype(o.mat_dtype or o.dtype), self.device)

    def _freeze_level(self, A, P, cf, fine: bool, skip_A: bool = False,
                      skip_PR: bool = False) -> AMGLevel:
        """dinv, l1inv and the coarsest pinv are computed in numpy f64
        and then cast.  The fine A keeps `dtype` (it defines the
        residual PCG minimizes); coarse A, P and R use `mat_dtype`.
        skip_A / skip_PR leave out forms a lattice build step replaces."""
        o = self.opts
        dev = self.device
        dt = torch_dtype(o.dtype)
        n = A.shape[0]
        dinv, l1inv = self._inverses(A)
        coarsest = P is None
        coarse_inv = None
        if coarsest:
            coarse_inv = to_device(
                np.linalg.pinv(A.toarray(), rcond=1e-12), dt, dev)
        if skip_A:
            A_frozen = None
        elif fine:
            A_frozen = freeze_auto(CSRMatrix.from_scipy(A), dt, dev)
        else:
            A_frozen = self._freeze_compact(A)
        no_PR = coarsest or skip_PR
        relax_types = ({o.relax_down, o.relax_up} if not coarsest
                       else {o.relax_coarse})
        gs_fwd = gs_bwd = cheby = None
        if not coarsest and relax_types & set(_GS_TYPES):
            with timed("GS_SCHEDULE", device=dev):
                gs_fwd, gs_bwd = self._gs_schedules(A, cf)
        if not coarsest and 16 in relax_types:
            cheby = cheby_setup(CSRMatrix.from_scipy(A), o.cheby_order,
                                o.cheby_ratio, device=dev)
        return AMGLevel(
            A=A_frozen,
            dinv=to_device(dinv, dt, dev),
            l1inv=to_device(l1inv, dt, dev),
            cmask=torch.from_numpy(
                cf > 0 if cf is not None else np.zeros(n, bool)).to(dev),
            P=None if no_PR else self._freeze_compact(P),
            R=None if no_PR else self._freeze_compact(P.T.tocsr()),
            coarse_inv=coarse_inv,
            gs_fwd=gs_fwd,
            gs_bwd=gs_bwd,
            cheby=cheby,
        )

    def _gs_schedules(self, A, cf):
        """(forward, backward) GS schedules of a host level, sharing one
        GSMatrix on the device; each a (C, F) pair of masked schedules
        with relax_order 1 (par_cycle.c:398).  The divisor is the
        diagonal, 1 where it is 0: option-4's l1 divisor degenerates to
        |diag| on one partition, the sign following the diagonal
        (ams.c:642-660)."""
        Ah = CSRMatrix.from_scipy(A)
        diag = A.diagonal()
        gs_div = np.where(diag == 0, 1.0, diag)
        mat = GSMatrix.build(Ah, gs_div, self.device)

        def build(forward, mask=None):
            return build_gs_schedule(Ah, forward, gs_div, mask=mask,
                                     device=self.device, mat=mat)

        if self.opts.relax_order == 1 and cf is not None:
            cm = cf > 0
            return ((build(True, cm), build(True, ~cm)),
                    (build(False, cm), build(False, ~cm)))
        return build(True), build(False)

    # ------------------------------------------------------------------
    # the lattice forms (host planning, device build)
    # ------------------------------------------------------------------
    def _jacobi_updown(self) -> bool:
        """The lattice levels smooth with the Jacobi family only."""
        o = self.opts
        return not ({o.relax_down, o.relax_up} - {0, 7, 18})

    def _embedded_level_vectors(self, A, cf, pos, n_emb):
        """(dinv, l1inv, cmask) of a level whose points sit at lattice
        positions `pos` of an n_emb-point lattice: zero / False off them."""
        dt = torch_dtype(self.opts.dtype)
        out = []
        for v in self._inverses(A):
            e = np.zeros(n_emb)
            e[pos] = v
            out.append(to_device(e, dt, self.device))
        cmask = np.zeros(n_emb, dtype=bool)
        cmask[pos[cf > 0]] = True
        return (*out, torch.from_numpy(cmask).to(self.device))

    def _wrap_compact_transfers(self, k, lvl, pos, n_emb):
        """(P, R) of level k, whose points sit at `pos` of an n_emb-point
        lattice while level k+1 stays compact: the frozen compact forms
        behind one scatter / gather."""
        innerP, innerR = lvl.P, lvl.R
        if innerP is None:  # was skipped in the freeze loop
            innerP = self._freeze_compact(self._host_P[k])
            innerR = self._freeze_compact(self._host_P[k].T.tocsr())
        dev = self.device
        return (ScatterOp(inner=innerP, pos=torch.from_numpy(pos).to(dev),
                          n_out=n_emb),
                GatherOp(inner=innerR,
                         pos=torch.from_numpy(pos.astype(np.int32)).to(dev)))

    def _plan_embed(self):
        """Return cpos0 (level-1 point positions on the fine lattice) if
        the level-1 embedding applies, else None.  Pure planning: the
        gates mirror what the build needs, nothing is built."""
        o = self.opts
        if not o.embed_level1 or len(self._host_A) < 3:
            return None
        if not self._jacobi_updown():
            return None  # embedded smoothing is for the Jacobi family only
        # the fine operator must itself freeze to DIA (freeze_auto's
        # criteria: square, above the dense threshold, few diagonals)
        A0 = self._host_A[0]
        n0, m0 = A0.shape
        if n0 != m0 or n0 <= DENSE_MAX_ROWS or A0.nnz == 0:
            return None
        if len(native.dia_offsets_only(A0)) > DIA_MAX_OFFSETS:
            return None
        cpos0 = np.flatnonzero(self._cf[0] > 0).astype(np.int64)
        if (embedded_offset_count(self._host_A[1], cpos0, cpos0)
                > o.max_embedded_offsets):
            return None
        return cpos0

    def _build_embed_level1(self, cpos0, will_reloc_l2: bool) -> None:
        """Lift level-1 A and the level-0 transfers onto the fine lattice
        as DIA.  With device_rap (the JAX package's use_device_rap
        branch) only the embedded P is built here: level-0 R and level-1
        A are left to `_run_device_rap`, which this plans; otherwise
        both are built from the host values."""
        o = self.opts
        mdt = torch_dtype(o.mat_dtype or o.dtype)
        dev = self.device
        n0 = self._host_A[0].shape[0]
        A1, P0 = self._host_A[1], self._host_P[0]
        idx = np.arange(n0, dtype=np.int64)
        use_device_rap = o.device_rap and self._host_A1_unf is not None
        self.levels[0] = dataclasses.replace(
            self.levels[0],
            P=build_embedded_dia(P0, idx, cpos0, n0, mdt, dev),
            R=None if use_device_rap else build_embedded_dia(
                P0.T.tocsr(), cpos0, idx, n0, mdt, dev),
        )
        dinv_e, l1inv_e, cmask_e = self._embedded_level_vectors(
            A1, self._cf[1], cpos0, n0)
        # level-1 transfers: the compact frozen P1/R1 behind scatter /
        # gather, unless the relocation of level 2 replaces them with
        # parity operators
        new_P = new_R = None
        if self._host_P[1:] and not will_reloc_l2:
            new_P, new_R = self._wrap_compact_transfers(
                1, self.levels[1], cpos0, n0)
        if use_device_rap:
            # dinv / l1inv / cmask stay host-exact (f64)
            self._pending_rap = self._device_rap_plan(cpos0)
            A_emb = None
        else:
            A_emb = build_embedded_dia(A1, cpos0, cpos0, n0, mdt, dev)
        self.levels[1] = dataclasses.replace(
            self.levels[1], A=A_emb, dinv=dinv_e, l1inv=l1inv_e,
            cmask=cmask_e, P=new_P, R=new_R,
        )

    def _device_rap_plan(self, cpos0) -> dict:
        """The device RAP's host side: the symbolic plan over the
        embedded offsets of P0, the fine A and level 1 before and after
        the non-Galerkin filter; the filter's tol, the storage dtype and
        the stored offsets."""
        n0 = self._host_A[0].shape[0]
        idx = np.arange(n0, dtype=np.int64)
        offs_filt = embedded_offsets(self._host_A[1], cpos0, cpos0)
        return dict(
            plan=plan_embedded_rap(
                embedded_offsets(self._host_P[0], idx, cpos0),
                embedded_offsets(self._host_A[0], idx, idx),
                embedded_offsets(self._host_A1_unf, cpos0, cpos0),
                offs_filt),
            tol=self._level_ngt(0),
            mdt=torch_dtype(self.opts.mat_dtype or self.opts.dtype),
            offsets=tuple(int(x) for x in offs_filt))

    def _run_device_rap(self) -> None:
        """Level-0 R as the device transpose of the embedded P (bitwise
        the host-built one), and level-1 A from the device pass
        (ops/device_rap.py) over the fine A and the embedded P."""
        p = self._pending_rap
        self._pending_rap = None
        P0 = self.levels[0].P
        self.levels[0] = dataclasses.replace(
            self.levels[0], R=dia_transpose_device(P0))
        data, _, _ = embedded_rap_device(P0, self.levels[0].A, p["plan"],
                                         p["tol"], p["mdt"])
        n0 = P0.num_rows
        self.levels[1] = dataclasses.replace(
            self.levels[1], A=DIAMatrix(data=data, offsets=p["offsets"],
                                        num_rows=n0, num_cols=n0))

    def _plan_reloc(self, cpos0) -> list:
        """Plan the relocation chain (see _build_relocated): per level k,
        the distinct-cell assignment rcell and lattice/factor geometry,
        with all offset gates evaluated, but no DIA data built.
        Returns a list of dicts (possibly empty)."""
        o = self.opts
        if not o.relocate_level2 or o.lattice_shape is None or cpos0 is None:
            return []
        shape = tuple(int(s) for s in o.lattice_shape)
        if len(shape) == 2:
            shape = (*shape, 1)
        if len(shape) != 3:
            return []
        L = len(self._host_A)
        n0 = self._host_A[0].shape[0]
        if int(np.prod(shape)) != n0:
            return []
        if L < 4:
            return []
        # small level-2 operators freeze dense: faster than a lattice form
        if self._host_A[2].shape[0] <= o.relocate_min_n2:
            return []
        if not self._jacobi_updown():
            return []

        itemsize = torch_dtype(o.mat_dtype or o.dtype).itemsize

        def pick_factors(lat_shape, npts):
            # The JAX package never splits the x axis unless forced: x is
            # the minor (lane) dimension on the TPU, where a stride-2
            # slice is a costly relayout.  That reason is the TPU's, but
            # the choice is kept so both packages build one hierarchy.
            # Among the candidates, the FITTING one with the FEWEST
            # cells: the lattice load factor multiplies every relocated
            # operator's stored width.
            best = None
            for fx in (1, 2):
                for fy in (1, 2, 4):
                    for fz in (1, 2, 4):
                        if fx * fy * fz == 1:
                            continue
                        if any(s % f for s, f in zip(lat_shape, (fx, fy, fz))):
                            continue
                        nc = (
                            (lat_shape[0] // fx)
                            * (lat_shape[1] // fy)
                            * (lat_shape[2] // fz)
                        )
                        if npts > 0.85 * nc:
                            continue
                        if best is None or (fx, nc) < (best[0][0], best[1]):
                            best = ((fx, fy, fz), nc)
            return best[0] if best else None

        # state: level k-1 lives on `lat_shape` with its points at
        # `pos_prev` (level-1 points sit at their true positions)
        plan = []
        lat_shape = shape
        pos_prev = cpos0
        for k in range(2, L - 1):
            n_k = self._host_A[k].shape[0]
            if n_k <= 64:
                break
            pos_k = pos_prev[self._cf[k - 1] > 0]
            factors = pick_factors(lat_shape, n_k)
            if factors is None:
                break
            cell_shape = tuple(s // f for s, f in zip(lat_shape, factors))
            ncells = int(np.prod(cell_shape))
            rcell = relocate_to_cells(pos_k, lat_shape, factors)
            if rcell is None:
                break
            A_k = self._host_A[k]
            tmin = tail_min_count(ncells, itemsize) if o.relocate_tail else 0
            if n_k > DENSE_MAX_ROWS:
                cnt = embedded_offset_count(A_k, rcell, rcell, tail_min=tmin)
                if cnt > o.max_relocated_offsets or (
                    cnt * ncells * itemsize > o.relocate_max_bytes
                ):
                    break
            # parity transfer budget, counted without building the data
            Pk1 = self._host_P[k - 1].tocoo()
            ncells_prev = int(np.prod(lat_shape))
            Pf = sp.csr_matrix(
                (Pk1.data, (pos_prev[Pk1.row], Pk1.col)),
                shape=(ncells_prev, n_k),
            )
            pr_offs = max(
                parity_offset_count_plan(
                    Pf, rcell, lat_shape, factors, False, tail_min=tmin
                ),
                parity_offset_count_plan(
                    Pf.T.tocsr(), rcell, lat_shape, factors, True,
                    tail_min=tmin,
                ),
            )
            if pr_offs > o.max_relocated_offsets or (
                pr_offs * ncells * itemsize > o.relocate_max_bytes
            ):
                break
            plan.append(dict(
                k=k, rcell=rcell, lat_shape=lat_shape, factors=factors,
                cell_shape=cell_shape, ncells=ncells, Pf=Pf, tail_min=tmin,
            ))
            lat_shape = cell_shape
            pos_prev = rcell
        return plan

    def _build_relocated(self, plan: list) -> None:
        """Relocate coarse levels onto per-level compact lattices.
        Level k's points (an irregular algebraic subset of level k-1's)
        are assigned DISTINCT cells of level k-1's lattice coarsened by
        per-axis factors: a pure permutation, so AMG convergence is
        unchanged.  A_k becomes a DIA operator (with its rare diagonals
        in a COOTail) on its compact lattice while n_k is large, or a
        dense operator behind one gather / scatter; P_{k-1} / R_{k-1}
        become parity-factored DIA sums.  The chain stops where
        _plan_reloc stopped; the level below a stop keeps its compact
        forms behind one gather / scatter."""
        o = self.opts
        mdt = torch_dtype(o.mat_dtype or o.dtype)
        dev = self.device
        relocated_ks = {ent["k"] for ent in plan}
        self._reloc_cells = {
            ent["k"]: (ent["rcell"], ent["ncells"]) for ent in plan
        }
        for ent in plan:
            k, rcell, ncells = ent["k"], ent["rcell"], ent["ncells"]
            lat_shape, factors, Pf = ent["lat_shape"], ent["factors"], ent["Pf"]
            tmin = ent["tail_min"]
            A_k = self._host_A[k]
            n_k = A_k.shape[0]
            if n_k > DENSE_MAX_ROWS:
                A_new = build_embedded_dia(A_k, rcell, rcell, ncells, mdt, dev,
                                           tail_min=tmin)
            else:
                # dense core behind one gather / scatter
                dense = DenseMatrix(data=to_device(A_k.toarray(), mdt, dev),
                                    num_rows=n_k, num_cols=n_k)
                A_new = self._on_cells(dense, rcell, ncells)
            # parity transfer operators between lattice k-1 and k
            self.levels[k - 1] = dataclasses.replace(
                self.levels[k - 1],
                P=build_parity_interp(Pf, rcell, lat_shape, factors, mdt, dev,
                                      tail_min=tmin),
                R=build_parity_restrict(Pf.T.tocsr(), rcell, lat_shape,
                                        factors, mdt, dev, tail_min=tmin),
            )
            lvl_k = self.levels[k]
            new_P, new_R = lvl_k.P, lvl_k.R
            if k + 1 in relocated_ks:
                # the next chain step installs parity operators here
                new_P = new_R = None
            elif k < len(self._host_P):
                new_P, new_R = self._wrap_compact_transfers(
                    k, lvl_k, rcell, ncells)
            dinv_e, l1inv_e, cmask_e = self._embedded_level_vectors(
                A_k, self._cf[k], rcell, ncells)
            self.levels[k] = dataclasses.replace(
                lvl_k, A=A_new, dinv=dinv_e, l1inv=l1inv_e, cmask=cmask_e,
                P=new_P, R=new_R,
            )

    def _on_cells(self, dense: DenseMatrix, rcell, ncells: int) -> ScatterOp:
        """A compact square operator applied on the cell lattice its
        points were relocated to: gather, apply, scatter (one
        `cell_dense` launch on the card)."""
        return on_cells(dense, rcell, ncells, self.device)

    def _build_coarse_collapse(self) -> None:
        """Materialize the sub-V-cycle below the first small level as one
        dense operator and truncate the frozen hierarchy there (see the
        JAX package's BoomerAMGOptions.collapse_coarse_n).

        The V-cycle below level ls, applied to a zero initial guess, is
        the fixed linear map
            M_l = post(I - A X) . [X + P M_{l+1} R (I - A X)],
            X = pre-smooth polynomial, bottom M_{L-1} = pinv(A)
        for the linear smoothers (relax 0/5/7/18: x += w*div*(f - Ax)).
        The recurrence is evaluated bottom-up with dense `torch.matmul`
        products on the device (A, P, R densified there from their
        nonzeros) and installed as levels[ls].coarse_inv, which the
        cycle's relax_coarse=9 branch applies as the coarse solve.
        Exact linear algebra: the preconditioner changes only by
        rounding; what it removes is the deep levels' launches."""
        o = self.opts
        if (o.collapse_coarse_n <= 0 or o.cycle_type != 1 or o.fcycle
                or max(o.additive, o.mult_additive, o.simple) >= 0
                or o.seq_threshold > 0
                or o.relax_order == 1
                or o.relax_coarse != 9 or o.smooth_num_levels > 0
                or o.grid_relax_type is not None
                or o.grid_relax_points is not None
                or not {o.relax_down, o.relax_up} <= {0, 5, 7, 18}
                or (o.num_sweeps_down or o.num_sweeps) != o.num_sweeps
                or (o.num_sweeps_up or o.num_sweeps) != o.num_sweeps):
            return
        L = len(self._host_A)

        def _ls_ok(l: int) -> bool:
            if self._host_A[l].shape[0] > o.collapse_coarse_n:
                return False
            if l in self._reloc_cells:
                return True  # handled by the gather / scatter wrap below
            lv = self.levels[l]
            # the collapsed map is built in HOST indexing: a frozen level
            # living on an embedded lattice cannot take it directly
            if lv.A is not None and lv.A.num_rows != self._host_A[l].shape[0]:
                return False
            Rprev = self.levels[l - 1].R
            if (Rprev is not None
                    and getattr(Rprev, "num_rows", None)
                    not in (None, self._host_A[l].shape[0])):
                return False
            return True

        ls = next((l for l in range(1, L - 1) if _ls_ok(l)), None)
        if ls is None or self.levels[-1].coarse_inv is None:
            return
        dt = torch_dtype(o.dtype)
        dev = self.device
        sweeps = o.num_sweeps

        def dense(S) -> torch.Tensor:
            # ship the nonzeros, build the dense image on the device
            C = S.tocoo()
            n, m = S.shape
            out = torch.zeros(n * m, dtype=dt, device=dev)
            flat = C.row.astype(np.int64) * m + C.col
            out[torch.from_numpy(flat).to(dev)] = to_device(C.data, dt, dev)
            return out.view(n, m)

        M = self.levels[-1].coarse_inv.to(dt)
        for l in range(L - 2, ls - 1, -1):
            Ah, Ph = self._host_A[l], self._host_P[l]
            dinv, l1inv = self._inverses(Ah)
            wl = self._level_weight(l)
            wdn = to_device(wl * (l1inv if o.relax_down == 18 else dinv),
                            dt, dev)[:, None]
            wup = to_device(wl * (l1inv if o.relax_up == 18 else dinv),
                            dt, dev)[:, None]
            A, P, R = dense(Ah), dense(Ph), dense(Ph.T.tocsr())
            eye = torch.eye(Ah.shape[0], dtype=dt, device=dev)
            X = wdn * eye  # zero-guess first sweep
            for _ in range(sweeps - 1):
                X = X + wdn * (eye - A @ X)
            X = X + P @ (M @ (R @ (eye - A @ X)))
            for _ in range(sweeps):
                X = X + wup * (eye - A @ X)
            M = X
        n_ls = self._host_A[ls].shape[0]
        op = DenseMatrix(data=M, num_rows=n_ls, num_cols=n_ls)
        if ls in self._reloc_cells:
            op = self._on_cells(op, *self._reloc_cells[ls])
        self.levels = self.levels[:ls] + [dataclasses.replace(
            self.levels[ls], coarse_inv=op, P=None, R=None,
        )]

    # ------------------------------------------------------------------
    # cycle (device)
    # ------------------------------------------------------------------
    def _relax_plan(self, position: str):
        """(relax_type, sweeps) for "down", "up" or "coarse"."""
        o = self.opts
        if position == "coarse":
            rt = o.relax_coarse
            return rt, ((o.num_sweeps_coarse or o.num_sweeps) if rt != 9 else 1)
        if position == "down":
            return o.relax_down, o.num_sweeps_down or o.num_sweeps
        return o.relax_up, o.num_sweeps_up or o.num_sweeps

    def _level_weight(self, level: int) -> float:
        """relax_weight[level] with the scalar fallback; deeper levels
        clamp to the last array entry."""
        o = self.opts
        lw = o.level_relax_weights
        if lw is None or not len(lw):
            return o.relax_weight
        return float(lw[min(level, len(lw) - 1)])

    def _level_omega(self, level: int) -> float:
        """omega[level] (par_amg.h; SetLevelOuterWt) with the scalar
        fallback; deeper levels clamp to the last array entry."""
        o = self.opts
        lo = o.level_omegas
        if lo is None or not len(lo):
            return o.omega
        return float(lo[min(level, len(lo) - 1)])

    def _smooth(self, lvl: AMGLevel, relax_type: int, u, f, up: bool,
                level: int, u_zero: bool = False):
        """u_zero: the caller guarantees u == 0 (the first down-smooth
        of every level inside a preconditioner cycle); Jacobi sweeps
        then skip the A @ 0 matvec with a bitwise-identical result.  The
        other smoothers ignore it, as in the JAX package (GS sweeps the
        zero vector)."""
        w = self._level_weight(level)
        if relax_type == 9:
            ci = lvl.coarse_inv
            # the dense pinv, or the collapsed sub-cycle as an operator
            return ci @ f if isinstance(ci, torch.Tensor) else spmv(ci, f)
        if relax_type not in _JACOBI:
            return self._smooth_other(lvl, relax_type, u, f, up, level, w)
        # 0/7 weighted Jacobi; 5 chaotic GS (== Jacobi on a data-parallel
        # machine); 18 l1-Jacobi
        div = lvl.l1inv if relax_type == 18 else lvl.dinv
        if self.opts.relax_order == 1:
            # CF-ordered sweeps (par_cycle.c:398): down C then F, up F then C
            order = ((~lvl.cmask, lvl.cmask) if up
                     else (lvl.cmask, ~lvl.cmask))
            for mask in order:
                if u_zero:
                    u = torch.where(mask, w * div * f, 0.0)
                    u_zero = False
                else:
                    u = jacobi_cf(lvl.A, div, u, f, mask, w)
            return u
        if u_zero:
            return w * div * f
        return jacobi(lvl.A, div, u, f, w)

    def _smooth_other(self, lvl: AMGLevel, relax_type: int, u, f, up: bool,
                      level: int, w: float):
        """The Gauss-Seidel family, Chebyshev, FCF-Jacobi and the CG
        smoother (the JAX package's _smooth, boomeramg.py:1861-1908)."""
        if relax_type in (1, 2, 3, 13):
            # sequential/hybrid forward GS (np=1: true GS; 13 = L1-GS
            # whose option-4 divisor degenerates to |diag|).  omega
            # applies to the hybrid SOR/L1 members (3/13 — par_relax.c
            # has the prod=(1-w*omega) branch in both, :1277/:4525);
            # the pure-sequential 1/2 branches carry no omega term.
            om = (self._level_omega(level) if relax_type in (3, 13)
                  else 1.0)
            return self._gs(lvl.gs_fwd, u, f, w, up, omega=om)
        if relax_type in (4, 14):
            return self._gs(lvl.gs_bwd, u, f, w, up,
                            omega=self._level_omega(level))
        if relax_type in (6, 8):
            # hybrid SSOR / L1-SSOR (same degenerate divisor at np=1).
            # ONE Vtemp copy per Relax call (par_relax.c:3148): the
            # backward half-sweep's S_pre uses the pre-FORWARD iterate.
            om = self._level_omega(level)
            v0 = u if om != 1.0 else None
            u = self._gs(lvl.gs_fwd, u, f, w, up, omega=om, v=v0)
            return self._gs(lvl.gs_bwd, u, f, w, up, omega=om, v=v0)
        if relax_type == 16:
            return chebyshev(lvl.A, lvl.cheby, u, f)
        if relax_type == 17:
            # FCF-Jacobi (par_relax_more.c:661): weighted Jacobi on
            # F, then C, then F points
            for mask in (~lvl.cmask, lvl.cmask, ~lvl.cmask):
                u = jacobi_cf(lvl.A, lvl.dinv, u, f, mask, w)
            return u
        if relax_type == 15:
            # CG smoother (par_relax_more.c hypre_ParCSRRelax_CG): a few
            # unpreconditioned CG iterations as the smoothing operator
            r = spmv_resid(lvl.A, u, f)
            p = r
            rr = torch.dot(r, r)
            for _ in range(3):
                Ap = spmv(lvl.A, p)
                denom = torch.dot(p, Ap)
                alpha = torch.where(
                    denom != 0, rr / torch.where(denom == 0, 1, denom), 0.0)
                u = u + alpha * p
                r = r - alpha * Ap
                rr_new = torch.dot(r, r)
                beta = torch.where(
                    rr != 0, rr_new / torch.where(rr == 0, 1, rr), 0.0)
                p = r + beta * p
                rr = rr_new
            return u
        raise NotImplementedError(f"relax_type {relax_type} is not "
                                  f"implemented in the port")

    @staticmethod
    def _gs(sched, u, f, w, up, omega: float = 1.0, v=None):
        """One GS relaxation call: a sweep of `sched`, or with a (C, F)
        pair (relax_order 1) down C then F, up F then C (par_cycle.c:398),
        each half-sweep its own hypre Relax call (a fresh Vtemp unless
        the caller pinned one: SSOR)."""
        if isinstance(sched, tuple):
            sc, sf = sched
            for sd in ((sf, sc) if up else (sc, sf)):
                u = gauss_seidel(sd, u, f, w, omega=omega, v=v)
            return u
        return gauss_seidel(sched, u, f, w, omega=omega, v=v)

    def _smooth_launches(self, lvl: AMGLevel, relax_type: int, sweeps: int,
                         u_zero: bool) -> tuple[int, int]:
        """(applications of A, GS sweeps) of one `_smooth` position of
        `sweeps` sweeps; u_zero: the first sweep starts from zero."""
        if relax_type in _JACOBI:
            halves = 2 if self.opts.relax_order == 1 else 1
            return sweeps * halves - (1 if u_zero else 0), 0
        if relax_type in _GS_TYPES:
            calls = 2 if relax_type in (6, 8) else 1
            halves = 2 if isinstance(lvl.gs_fwd, tuple) else 1
            return 0, sweeps * calls * halves
        if relax_type == 16:
            return sweeps * lvl.cheby.order, 0
        return sweeps * {15: 4, 17: 3}[relax_type], 0

    def cycle_launches(self) -> dict:
        """{kernel name: launches} of one V-cycle from a zero initial
        guess (the PCG preconditioner's), from the levels' formats
        (ops/dia.py::kernel_launches) and the smoothers: the smoothing
        matvecs, each level's residual, restriction and prolongation,
        the coarse solve where it is an operator, and "gs_sweep", one
        launch a GS sweep of a level."""
        from ...ops.dia import kernel_launches

        out: dict = {"gs_sweep": 0}

        def add(op, k):
            for name, c in kernel_launches(op).items():
                out[name] = out.get(name, 0) + k * c

        levels = self.levels
        L = len(levels)
        rt_c, ns_c = self._relax_plan("coarse")
        if L > 1:
            rt_d, ns_d = self._relax_plan("down")
            rt_u, ns_u = self._relax_plan("up")
            for lvl in levels[:-1]:
                for rt, ns, uz in ((rt_d, ns_d, True), (rt_u, ns_u, False)):
                    na, gs = self._smooth_launches(lvl, rt, ns, uz)
                    add(lvl.A, na)
                    out["gs_sweep"] += gs
                add(lvl.A, 1)  # the residual
                add(lvl.R, 1)
                add(lvl.P, 1)
        if rt_c == 9:
            ci = levels[-1].coarse_inv
            if not isinstance(ci, torch.Tensor):
                add(ci, 1)
        else:
            add(levels[-1].A, self._smooth_launches(
                levels[-1], rt_c, ns_c if L > 1 else 1, False)[0])
        return out

    def cycle(self, f, u=None):
        """One V-cycle (cycle_type 1, par_cycle.c).  With u None the
        initial guess is zero and the first down-smooths skip their
        A @ 0 matvecs."""
        levels = self.levels
        L = len(levels)
        u_zero = u is None
        U = [None] * L
        F = [None] * L
        F[0] = f
        U[0] = torch.zeros_like(f) if u is None else u
        if L == 1:
            return self._smooth(levels[0], self.opts.relax_coarse, U[0], f,
                                up=False, level=0)
        rt, ns = self._relax_plan("down")
        for l in range(L - 1):
            lvl = levels[l]
            for _ in range(ns):
                U[l] = self._smooth(lvl, rt, U[l], F[l], up=False, level=l,
                                    u_zero=u_zero)
                u_zero = False
            r = spmv_resid(lvl.A, U[l], F[l])
            F[l + 1] = spmv(lvl.R, r)
            U[l + 1] = torch.zeros_like(F[l + 1])
            u_zero = True
        # the coarsest solve gets no u_zero shortcut, as in the state
        # machine's cycle_param 3
        rt, ns = self._relax_plan("coarse")
        for _ in range(ns):
            U[L - 1] = self._smooth(levels[L - 1], rt, U[L - 1], F[L - 1],
                                    up=False, level=L - 1)
        rt, ns = self._relax_plan("up")
        for l in range(L - 2, -1, -1):
            U[l] = spmv_axpy(levels[l].P, U[l + 1], U[l])
            for _ in range(ns):
                U[l] = self._smooth(levels[l], rt, U[l], F[l], up=True, level=l)
        return U[0]

    @property
    def precond(self):
        """M(r) -> z: one cycle with zero initial guess (the PCG hook)."""
        return lambda r: self.cycle(r)

    # ------------------------------------------------------------------
    # standalone solve (par_amg_solve.c)
    # ------------------------------------------------------------------
    def solve(self, b, x0=None, tol: float = 1e-7, max_iter: int = 20,
              min_iter: int = 0) -> SolverResult:
        """Iterate V-cycles until ||r||/||b|| < tol (par_amg_solve.c:243;
        hypre's solver 0).  x0 defaults to zeros of the fine operator's
        dtype.  A Python loop that reads the stop test on the host once
        an iteration, as pcg's does; the residual history lands in a
        NaN-padded [max_iter + 1] tensor."""
        A = self.levels[0].A
        x = (torch.zeros(A.num_rows, dtype=A.data.dtype, device=b.device)
             if x0 is None else x0)
        b_norm = torch.sqrt(torch.dot(b, b))
        r0 = spmv_resid(A, x, b)
        rnorm = torch.sqrt(torch.dot(r0, r0))
        den = torch.where(b_norm > 0, b_norm,
                          torch.where(rnorm > 0, rnorm, 1.0))
        norms = torch.full((max_iter + 1,), float("nan"), dtype=b.dtype,
                           device=b.device)
        norms[0] = rnorm
        i = 0
        while i < max_iter and (i < min_iter or bool(rnorm / den >= tol)):
            x = self.cycle(b, x)
            r = spmv_resid(A, x, b)
            rnorm = torch.sqrt(torch.dot(r, r))
            i += 1
            norms[i] = rnorm
        rel = rnorm / den
        return SolverResult(x=x, num_iterations=i, rel_residual_norm=rel,
                            converged=bool(rel < tol), res_norms=norms)
