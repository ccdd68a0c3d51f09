"""BoomerAMG: hierarchy setup + V-cycle (port of the slice's part of
hypre_tpu/solvers/amg/boomeramg.py).

Reference: parcsr_ls/par_amg_setup.c (hypre_BoomerAMGSetup), par_cycle.c
(hypre_BoomerAMGCycle).

Setup is host-side numpy/scipy plus the native C kernels, as in the JAX
package: PMIS coarsening, modified classical interpolation, truncation,
Galerkin RAP and the optional non-Galerkin filter.  Each level is then
frozen into torch tensors on an explicit device, and the V-cycle runs
eagerly on that device.  The fine operator is DIA (its matvec is the
hand-written kernel K1 on CUDA), coarse levels are ELL or dense.

The slice implements the options of the bench protocol (relax 0/5/7/18
with relax_coarse 9, V-cycles).  Every other option must keep its
default, and the lattice forms the JAX package adds on top
(embed_level1, relocate_level2, collapse_coarse_n) must be off:
`check_options` raises NotImplementedError otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ...ops.csr import CSRMatrix, to_device, torch_dtype
from ...ops.dia import freeze_auto, spmv, spmv_axpy, spmv_resid
from ...utils.timing import timed
from .coarsen import pmis_coarsen
from .interp import classical_interp, truncate_interp
from .rap import galerkin_rap, nongalerkin_filter
from .relax import jacobi, jacobi_cf
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


# The lattice forms: not ported yet, so they must be switched off.
_SLICE_VALUES = {"embed_level1": False, "relocate_level2": False,
                 "collapse_coarse_n": 0}
# Fields the slice implements (values checked below).  device_rap only
# steers how the level-1 embedding is built, which is off in the port,
# so either value means the same thing in both packages.
_IMPLEMENTED = frozenset({
    "max_levels", "max_coarse_size", "strong_threshold", "max_row_sum",
    "coarsen_type", "interp_type", "trunc_factor", "P_max_elmts",
    "nongalerkin_tol", "nongalerkin_lump", "relax_down", "relax_up",
    "relax_coarse", "relax_order", "relax_weight", "level_relax_weights",
    "num_sweeps", "num_sweeps_down", "num_sweeps_up", "num_sweeps_coarse",
    "min_coarse_size", "cycle_type", "seed", "dtype", "mat_dtype",
    "device_rap",
})
_JACOBI = (0, 5, 7, 18)
# (vector dtype, matrix dtype) pairs; K1 takes exactly these
_DTYPES = {("float64", "float64"), ("float32", "float32"),
           ("float32", "bfloat16")}


def check_options(o: BoomerAMGOptions) -> None:
    """Raise NotImplementedError for any option the slice does not
    implement; nothing is silently ignored."""
    for f in dataclasses.fields(o):
        v = getattr(o, f.name)
        if f.name in _SLICE_VALUES:
            if v != _SLICE_VALUES[f.name]:
                raise NotImplementedError(
                    f"{f.name}={v!r}: the lattice forms are not ported; "
                    f"set {f.name}={_SLICE_VALUES[f.name]!r}")
        elif f.name not in _IMPLEMENTED:
            changed = v is not None if f.default is None else v != f.default
            if changed:
                raise NotImplementedError(
                    f"{f.name}={v!r} is not implemented in the port "
                    f"(only the default {f.default!r})")
    checks = (
        ("coarsen_type", o.coarsen_type == "pmis"),
        ("interp_type", o.interp_type == "classical"),
        ("relax_down", o.relax_down in _JACOBI),
        ("relax_up", o.relax_up in _JACOBI),
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
    A: object  # DIAMatrix | ELLMatrix | DenseMatrix
    dinv: torch.Tensor
    l1inv: torch.Tensor
    cmask: torch.Tensor  # bool: CF_marker > 0 (all False on coarsest)
    P: Optional[object]  # None on coarsest
    R: Optional[object]  # P^T
    coarse_inv: Optional[torch.Tensor]  # dense pinv on coarsest


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
                    P = truncate_interp(classical_interp(A, S, cf),
                                        o.trunc_factor, o.P_max_elmts)
                with timed("RAP"):
                    Ac = galerkin_rap(A, P)
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
        L = len(self._host_A)
        with timed("FREEZE", device=self.device):
            for k in range(L):
                coarsest = k == L - 1
                self.levels.append(self._freeze_level(
                    self._host_A[k],
                    None if coarsest else self._host_P[k],
                    None if coarsest else self._cf[k],
                    fine=(k == 0),
                ))

    @staticmethod
    def _l1_norms(A) -> np.ndarray:
        """Row-wise sum of |a_ij|."""
        n = A.shape[0]
        if A.nnz == 0:
            return np.zeros(n)
        starts = np.minimum(A.indptr[:-1], A.nnz - 1)
        red = np.add.reduceat(np.abs(A.data), starts)
        return np.where(np.diff(A.indptr) > 0, red, 0.0)

    def _freeze_level(self, A, P, cf, fine: bool) -> AMGLevel:
        """dinv, l1inv and the coarsest pinv are computed in numpy f64
        and then cast.  The fine A keeps `dtype` (it defines the
        residual PCG minimizes); coarse A, P and R use `mat_dtype`."""
        o = self.opts
        dev = self.device
        dt = torch_dtype(o.dtype)
        pdt = torch_dtype(o.mat_dtype or o.dtype)
        mdt = dt if fine else pdt
        n = A.shape[0]
        diag = A.diagonal()
        safe = np.where(diag == 0, 1.0, diag)
        dinv = np.where(diag == 0, 0.0, 1.0 / safe)
        l1 = self._l1_norms(A)
        l1inv = np.where(l1 == 0, 0.0, 1.0 / np.where(l1 == 0, 1.0, l1))
        coarsest = P is None
        coarse_inv = None
        if coarsest:
            coarse_inv = to_device(
                np.linalg.pinv(A.toarray(), rcond=1e-12), dt, dev)
        return AMGLevel(
            A=freeze_auto(CSRMatrix.from_scipy(A), mdt, dev),
            dinv=to_device(dinv, dt, dev),
            l1inv=to_device(l1inv, dt, dev),
            cmask=torch.from_numpy(
                cf > 0 if cf is not None else np.zeros(n, bool)).to(dev),
            P=None if coarsest else freeze_auto(CSRMatrix.from_scipy(P), pdt, dev),
            R=None if coarsest else freeze_auto(
                CSRMatrix.from_scipy(P.T.tocsr()), pdt, dev),
            coarse_inv=coarse_inv,
        )

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

    def _smooth(self, lvl: AMGLevel, relax_type: int, u, f, up: bool,
                level: int, u_zero: bool = False):
        """u_zero: the caller guarantees u == 0 (the first down-smooth
        of every level inside a preconditioner cycle); Jacobi sweeps
        then skip the A @ 0 matvec with a bitwise-identical result."""
        w = self._level_weight(level)
        if relax_type == 9:
            return lvl.coarse_inv @ f
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
