"""BoomerAMG: hierarchy setup + cycles (port of the host-setup part of
hypre_tpu/solvers/amg/boomeramg.py).

Reference: parcsr_ls/par_amg_setup.c (hypre_BoomerAMGSetup), par_cycle.c
(hypre_BoomerAMGCycle).

Setup is host-side numpy/scipy plus the native C kernels, as in the JAX
package: classical, absolute or GSMG strength, PMIS / HMIS / RS / CLJP /
Falgout / CGC / CR coarsening (of the nodal norm matrix with nodal >
0), the aggressive second round on the first agg_num_levels levels
(multipass or the two-stage product), the nine interpolations of
interp_type, truncation, Jacobi post-interpolation, Galerkin RAP (R A P
with an AIR restriction R != P^T) and the optional non-Galerkin filter;
the smoothed solve-phase P of mult_additive / simple, and the nested
coarse BoomerAMG of seq_threshold.  Systems (num_functions > 1) take
the "unknown approach": strength and interpolation see only the
couplings within one function (`_mask_cross_dof`), RAP and the
smoothers the whole matrix, and dof_func follows the C points down the
hierarchy.  Each level is then frozen into torch tensors on an
explicit device, and the cycle runs eagerly on that device: hypre's
nonrecursive state machine (V, W and F cycles, par_cycle.c) or the
additive cycle (par_add_cycle.c).
The fine operator is DIA (its matvec is the hand-written kernel K1 on
CUDA).

With the lattice forms off (embed_level1=False, relocate_level2=False,
collapse_coarse_n=0) coarse levels are ELL or dense.  With the JAX
package's defaults the lattice forms of ops/dia.py apply wherever that
package's gates let them: level 1 is embedded on the fine lattice as
DIA (`_build_embed_level1`; with device_rap, the JAX package's default,
its values come from the device pass of ops/device_rap.py and level-0
R from a device transpose), deeper levels are relocated onto compact
cell lattices with parity-factored transfers and exact COO tails
(`_plan_reloc`, `_build_relocated`; needs `lattice_shape`), and the
sub-cycle below the first small level is collapsed into one dense
operator (`_build_coarse_collapse`).  A hierarchy that fails a gate
keeps the plain forms, as in the JAX package.  With an AIR restriction
(restrict_type > 0) the port declines the level-1 embedding and so the
relocation, which the JAX package does not: both build level 0's R (and
the relocated levels' parity R) from P^T, which would drop AIR's R.

With device_setup (bench.py's path at 96^3) level 0 -> 1 of the setup
runs on the device (`_device_setup_level0`: ops/device_setup.py and
device_coarsen.py): the fine operator as DIA (built there from index
masks with lattice_coeffs), strength and PMIS, classical interpolation
with truncation, the two-stage RAP with the non-Galerkin filter; the
host pulls back the CF marker and the compact level-1 operator and sets
up the deeper levels.  Level-0 P / R and the embedded level-1 A stay
the device's DIA tables (`_install_fast_levels`).  device_coarsen runs
only the level-0 PMIS on the device.

The port implements the options of the bench protocol (relax_coarse
0/5/7/18/9), the whole interpolation family (classical, direct, ext+i,
multipass, standard, standard-sep, ff, ff1, ext), aggressive coarsening
(agg_interp_type 4 and 1), Jacobi post-interpolation, AIR (restrict_type
1 / 2), the cycle options (V, W and F cycles, the additive family,
seq_threshold, grid_relax_type / grid_relax_points), the coarsening
family and strength_abs, the smoother family of the JAX package for the
down and up sweeps (relax 0/5/7/18 Jacobi, 1-4/6/8/13/14
level-scheduled Gauss-Seidel with omega and the CF-ordered sweeps of
relax_order 1, 15 CG, 16 Chebyshev, 17 FCF-Jacobi), the stationary
solve (`solve`, hypre's solver 0) and its transpose (`solveT`), the
statistics of par_stats.c, systems AMG (num_functions, dof_func,
nodal coarsening with nodal_diag, GSMG strength), the complex smoothers
of smooth_type on the first smooth_num_levels levels (6 Schwarz, 8
ParaSails, 9 Euclid with the euclid_* fields; they replace relaxation
there, and the lattice forms and the device chain decline such a
hierarchy, as in the JAX package) and the lattice path with the device
setup chain and the relocated forms' offset budgets: every option of
BoomerAMGOptions.  `check_options` raises NotImplementedError for a
value outside what the JAX package handles.
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
                        csr_to_dia, device_lattice_dia,
                        embedded_offset_count, embedded_offsets,
                        freeze_auto, on_cells, parity_offset_budget_filter,
                        parity_offset_count_plan, relocate_to_cells, spmv,
                        spmv_axpy, spmv_resid, tail_min_count)
from ...utils.timing import timed
from ..krylov.common import SolverResult
from .coarsen import (cljp_coarsen, cr_coarsen, falgout_coarsen,
                      hmis_coarsen, pmis_coarsen, ruge_stuben_coarsen)
from .device_coarsen import device_pmis
from .interp import (air_restriction, classical_interp, direct_interp,
                     extended_i_interp, extended_interp, ff_interp,
                     jacobi_interp, multipass_interp, standard_interp,
                     truncate_interp)
from .rap import galerkin_rap, nongalerkin_filter, offset_budget_filter
from .euclid import EuclidData, build_euclid, euclid_smooth
from .parasails import (ParaSailsData, ParaSailsOptions, build_parasails_data,
                        parasails_smooth)
from .relax import (ChebyData, GSMatrix, build_gs_schedule,
                    cheby_setup, chebyshev, gauss_seidel, jacobi, jacobi_cf)
from .schwarz import (SchwarzData, SchwarzOptions, build_schwarz_data,
                      schwarz_smooth)
from .strength import (create_nodal_A, gsmg_strength, second_strength,
                       strength_matrix, strength_matrix_abs)


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
    # (cx, cy, cz): the caller states that A is laplacian_7pt(*lattice_shape,
    # cx, cy, cz); the device setup then builds the fine DIA table on the
    # device instead of converting A
    lattice_coeffs: Optional[tuple] = None
    relocate_min_n2: int = 6144
    relocate_max_bytes: int = 3 << 30
    max_relocated_offsets: int = 8192
    relocate_offset_budget: int = 0
    transfer_offset_budget: int = 0
    relocate_lump: str = "diag"
    relocate_tail: bool = True
    collapse_coarse_n: int = 2048
    # level-0 PMIS on the device (the rest of the setup on the host)
    device_coarsen: bool = False
    device_rap: bool = True
    # the level-0 setup chain on the device (module docstring)
    device_setup: bool = False


# Fields the port implements (values checked below).  device_rap picks
# where the embedded level-1 values are computed (the device pass or the
# host product); without the embedding either value means the same
# thing in both packages.  device_setup, device_coarsen and
# lattice_coeffs act where their gates let them, as in the JAX package.
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
    "device_setup", "device_coarsen", "lattice_coeffs",
    "seq_threshold", "strength_abs", "fcycle", "grid_relax_type",
    "grid_relax_points", "additive", "mult_additive", "simple",
    "add_last_lvl", "add_P_max_elmts", "add_trunc_factor", "add_rlx",
    "add_rlx_wt", "agg_num_levels", "agg_P_max_elmts", "agg_trunc_factor",
    "agg_interp_type", "num_paths", "post_interp_type",
    "jacobi_trunc_threshold", "restrict_type", "filter_threshold_r",
    "air_neumann_degree", "num_functions", "dof_func", "nodal", "nodal_diag",
    "gsmg", "num_samples", "relocate_offset_budget",
    "transfer_offset_budget", "relocate_lump", "smooth_type",
    "smooth_num_levels", "euclid_domains", "euclid_fill", "euclid_colored",
})
_JACOBI = (0, 5, 7, 18)
# level-scheduled Gauss-Seidel: 1/2/3/13 forward, 4/14 backward, 6/8 both
_GS_TYPES = (1, 2, 3, 4, 6, 8, 13, 14)
# what the down and up sweeps take: the above, 15 CG, 16 Chebyshev, 17
# FCF-Jacobi (the coarsest level builds no GS schedule: relax_coarse
# keeps _JACOBI and 9)
_UPDOWN = _JACOBI + _GS_TYPES + (15, 16, 17)
# interp_type -> host interpolation (hypre interp_type 0, 3, 6, multipass,
# 8, 9, 12, 13, 14)
_INTERP = {
    "classical": classical_interp,
    "direct": direct_interp,
    "ext+i": extended_i_interp,
    "multipass": multipass_interp,
    "standard": standard_interp,
    "standard-sep": lambda A, S, cf: standard_interp(A, S, cf,
                                                     sep_weight=True),
    "ff": ff_interp,
    "ff1": lambda A, S, cf: ff_interp(A, S, cf, ff1=True),
    "ext": extended_interp,
}
# coarsen_type -> host coarsening of S (and A, which CR relaxes on).
# CGC (par_cgc_coarsen.c) picks among RS grids by subdomain; on one
# subdomain its only choice is the RS grid
_COARSEN = {
    "pmis": lambda S, A, seed: pmis_coarsen(S, seed=seed),
    "hmis": lambda S, A, seed: hmis_coarsen(S, seed=seed),
    "rs": lambda S, A, seed: ruge_stuben_coarsen(S),
    "cgc": lambda S, A, seed: ruge_stuben_coarsen(S),
    "cljp": lambda S, A, seed: cljp_coarsen(S, seed=seed),
    "falgout": lambda S, A, seed: falgout_coarsen(S, seed=seed),
    "cr": lambda S, A, seed: cr_coarsen(A, seed=seed),
}
# (vector dtype, matrix dtype) pairs; K1 takes exactly these
_DTYPES = {("float64", "float64"), ("float32", "float32"),
           ("float32", "bfloat16")}


def _combine_cf(cf: np.ndarray, cf2: np.ndarray) -> np.ndarray:
    """The aggressive round's CF marker: C where a point is C in both
    rounds (cf2 is over cf's C points, in order), the first round's C
    points F otherwise, its F and SF points as they were."""
    cidx1 = np.flatnonzero(cf > 0)
    out = np.where(cf > 0, -1, cf).astype(np.int64)
    out[cidx1[cf2 > 0]] = 1
    return out


def _updown_relax_types(o) -> set:
    """Effective down / up relax types: grid_relax_type[:3] when the
    old-style array (par_amg.h grid_relax_type[4]) is set, else
    {relax_down, relax_up}."""
    if o.grid_relax_type is not None:
        return {int(t) for t in o.grid_relax_type[:3]}
    return {o.relax_down, o.relax_up}


def _grid_arrays_ok(o) -> tuple[bool, bool]:
    """(grid_relax_type, grid_relax_points) well formed: four relax
    types, the first three down / up ones and the last a coarse one;
    four tuples of point classes, 0 all, 1 C, -1 F."""
    t, p = o.grid_relax_type, o.grid_relax_points
    t_ok = t is None or (len(t) == 4 and {int(x) for x in t[:3]} <= set(_UPDOWN)
                         and int(t[3]) in _JACOBI + (9,))
    p_ok = p is None or (len(p) == 4 and all(
        {int(x) for x in pos} <= {-1, 0, 1} for pos in p))
    return t_ok, p_ok


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
    grid_type_ok, grid_points_ok = _grid_arrays_ok(o)
    checks = (
        ("coarsen_type", o.coarsen_type in _COARSEN),
        ("interp_type", o.interp_type in _INTERP),
        ("relax_down", o.relax_down in _UPDOWN),
        ("relax_up", o.relax_up in _UPDOWN),
        ("relax_coarse", o.relax_coarse in _JACOBI + (9,)),
        ("relax_order", o.relax_order in (0, 1)),
        ("cycle_type", o.cycle_type >= 1),
        ("grid_relax_type", grid_type_ok),
        ("grid_relax_points", grid_points_ok),
        ("add_rlx", o.add_rlx in (0, 18)),
        ("agg_num_levels", o.agg_num_levels >= 0),
        ("agg_interp_type", o.agg_interp_type in (1, 4)),
        ("num_paths", o.num_paths >= 1),
        ("post_interp_type", o.post_interp_type >= 0),
        ("restrict_type", o.restrict_type in (0, 1, 2)),
        ("air_neumann_degree", o.air_neumann_degree >= -1),
        ("nongalerkin_lump", o.nongalerkin_lump in ("diag", "strong")),
        ("num_functions", o.num_functions >= 1),
        # create_nodal_A's norms: Frobenius, |.| sum, signed largest,
        # inf norm, signed sum
        ("nodal", o.nodal in (0, 1, 2, 3, 4, 6)),
        ("nodal_diag", o.nodal_diag in (0, 1, 2)),
        ("gsmg", o.gsmg >= 0),
        ("num_samples", o.num_samples >= 1),
        ("relocate_offset_budget", o.relocate_offset_budget >= 0),
        ("transfer_offset_budget", o.transfer_offset_budget >= 0),
        ("relocate_lump", o.relocate_lump in ("diag", "strong")),
        ("mat_dtype", (o.dtype, o.mat_dtype or o.dtype) in _DTYPES),
        # 6 Schwarz, 8 ParaSails, 9 Euclid; 0 (and any of them with
        # smooth_num_levels 0) relaxes
        ("smooth_type", o.smooth_type in (0, 6, 8, 9)),
        ("smooth_num_levels", o.smooth_num_levels >= 0),
        ("euclid_domains", o.euclid_domains >= 1),
        ("euclid_fill", o.euclid_fill >= 0),
        ("euclid_colored", o.euclid_colored in (True, False)),
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
    R: Optional[object]  # P^T, or the AIR restriction
    # on the coarsest level: the dense pinv (a tensor), or the collapsed
    # sub-cycle as an operator (DenseMatrix, or that behind Scatter/Gather)
    coarse_inv: Optional[object]
    # GS sweeps (relax 1-4, 6, 8, 13, 14): a schedule a direction, or a
    # (C, F) pair of them with relax_order 1; None on the coarsest
    gs_fwd: Optional[object] = None
    gs_bwd: Optional[object] = None
    cheby: Optional[ChebyData] = None  # relax 16
    # the complex smoother replacing relaxation on the first
    # smooth_num_levels levels (smooth_type 9 / 6 / 8)
    euclid: Optional[EuclidData] = None
    schwarz: Optional[SchwarzData] = None
    parasails: Optional[ParaSailsData] = None


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
        # each level's AIR restriction, None where R = P^T
        self._host_R: list[Optional[sp.csr_matrix]] = []
        self._cf: list[np.ndarray] = []
        self._reloc_cells: dict = {}  # level -> (cells of its points, ncells)
        # the level-1 Galerkin product before the non-Galerkin filter:
        # the device RAP's plan takes its offsets
        self._host_A1_unf: Optional[sp.csr_matrix] = None
        # the device setup chain's products (device_setup), else None
        self._fast: Optional[dict] = None
        # seq_threshold's nested coarse BoomerAMG, else None
        self._seq_coarse: Optional["BoomerAMG"] = None
        self._levels_T: Optional[list] = None  # levels_T, made on request
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
        self._host_A, self._host_P, self._host_R, self._cf = [], [], [], []
        self._reloc_cells = {}
        self._host_A1_unf = self._fast = self._seq_coarse = None
        self._levels_T = None
        return self

    @classmethod
    def from_host_levels(cls, host_A, host_P, cf, opts: BoomerAMGOptions, *,
                         device) -> "BoomerAMG":
        """An instance over a host hierarchy set up earlier (a checkpoint:
        utils/io.py::load_amg_hierarchy): the operators, the cycle's P
        and the CF markers of every level, R = P^T.  Everything the
        setup leaves beside them is made as the setup makes it (the
        level-1 Galerkin product before the non-Galerkin filter, which
        the device RAP's plan reads, and seq_threshold's nested
        BoomerAMG), then the hierarchy is frozen on `device` as
        __init__ freezes it."""
        check_options(opts)
        self = cls.__new__(cls)
        self.opts = opts
        self.device = torch.device(device)
        self.levels = []
        self._host_A, self._host_P = list(host_A), list(host_P)
        self._host_R = [None] * len(self._host_P)
        self._cf = list(cf)
        self._reloc_cells = {}
        self._fast = self._seq_coarse = self._levels_T = None
        self._host_A1_unf = None
        if len(self._host_A) > 1:
            self._host_A1_unf = (
                galerkin_rap(self._host_A[0], self._host_P[0])
                if self._level_ngt(0) > 0 else self._host_A[1])
        self._build_seq_coarse()
        self._freeze_hierarchy()
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
        nf = o.num_functions
        if o.dof_func is not None:
            dof = np.asarray(o.dof_func, dtype=np.int64)
            if dof.shape != (A.shape[0],):
                raise ValueError(f"dof_func has shape {dof.shape}, the "
                                 f"matrix {A.shape[0]} rows")
        else:
            dof = np.arange(A.shape[0], dtype=np.int64) % nf
        with timed("SETUP"):
            fast = (self._device_setup_level0(A) if self._fast_eligible(A)
                    else None)
            if fast is not None:
                # level 0 is the device's; the host goes on from level 1
                self._fast = fast
                self._host_A.append(A)
                self._host_P.append(None)  # device-resident (host_P(0))
                self._host_R.append(None)
                self._cf.append(fast["cf0"])
                A = fast["A1_host"]
            while True:
                n = A.shape[0]
                # what strength and interpolation see of a system
                A_si = A if nf <= 1 else self._mask_cross_dof(A, dof)
                last = (len(self._host_A) >= o.max_levels - 1
                        or n <= o.max_coarse_size
                        or (o.seq_threshold > 0 and n <= o.seq_threshold
                            and len(self._host_A) > 0))
                if not last:
                    with timed("STRENGTH"):
                        if o.gsmg > 0:
                            S = gsmg_strength(
                                A_si, o.num_samples, seed=o.seed,
                                dof_func=dof if nf > 1 else None)
                        elif o.strength_abs:
                            # the reference's useSabs call hardwires
                            # max_row_sum 1.0 (par_amg_setup.c:1040-1045):
                            # the user's max_row_sum is ignored here
                            S = strength_matrix_abs(A, o.strong_threshold, 1.0)
                        else:
                            S = strength_matrix(A_si, o.strong_threshold,
                                                o.max_row_sum)
                    with timed("COARSEN"):
                        cf = self._device_cf0(A)
                        if cf is None and nf > 1 and o.nodal > 0:
                            cf = self._nodal_cf(A)
                        elif cf is None:
                            cf = _COARSEN[o.coarsen_type](S, A, o.seed)
                    nc = int((cf > 0).sum())
                    if nc == 0 or nc == n or nc < o.min_coarse_size:
                        last = True
                if last:
                    self._host_A.append(A)
                    self._cf.append(np.zeros(n, dtype=np.int64))
                    break
                with timed("INTERP"):
                    P, cf = self._interp_level(A, A_si, S, cf)
                with timed("RAP"):
                    R = None  # R = P^T, made at freeze
                    if o.restrict_type > 0:
                        R = air_restriction(
                            A_si, S, cf, o.filter_threshold_r,
                            distance=o.restrict_type,
                            neumann_degree=o.air_neumann_degree)
                        Ac = (R @ (A @ P)).tocsr()
                        Ac.sort_indices()
                    else:
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
                self._host_R.append(R)
                self._cf.append(cf)
                A = Ac
                if nf > 1:
                    dof = dof[cf > 0]
            self._apply_mult_additive_P()
        # outside SETUP's scope: the nested instance times its own
        self._build_seq_coarse()

    @staticmethod
    def _mask_cross_dof(A, dof):
        """A with the couplings between different functions removed (the
        "unknown approach": par_strength.c:254 and the dof_func guards
        of every interpolation routine skip them; they are not lumped)."""
        Ac = A.tocoo(copy=True)
        keep = (dof[Ac.row] == dof[Ac.col]) | (Ac.row == Ac.col)
        Ac.data = np.where(keep, Ac.data, 0.0)
        M = Ac.tocsr()
        M.eliminate_zeros()
        M.sort_indices()
        return M

    def _nodal_cf(self, A) -> np.ndarray:
        """Nodal coarsening (par_nodal_systems.c): coarsen the nodal norm
        matrix (create_nodal_A with nodal / nodal_diag) and give every
        function of a node its node's CF decision.  The signed norms
        (3, 6) and any nodal_diag take the classical strength test, the
        others the absolute one (hypre_BoomerAMGCreateSabs)."""
        o = self.opts
        nf = o.num_functions
        AN = create_nodal_A(A, nf, o.nodal, o.nodal_diag)
        if o.nodal in (3, 6) or o.nodal_diag > 0:
            SN = strength_matrix(AN, o.strong_threshold, o.max_row_sum)
        else:
            SN = strength_matrix_abs(AN, o.strong_threshold, o.max_row_sum)
        # CR relaxes on AN (the JAX package hands it the unknown-wise A,
        # whose CF marker the repeat would then stretch nf-fold)
        return np.repeat(_COARSEN[o.coarsen_type](SN, AN, o.seed), nf)

    def _interp_level(self, A, A_si, S, cf):
        """(P, CF marker) of one level (the JAX package's boomeramg.py
        :503-572); A_si is A as strength and interpolation see it (of a
        system, without the cross-function couplings).  On the first
        agg_num_levels levels the aggressive round: with agg_interp_type
        4 a second coarsening of the C
        points on the S S + 2 S graph (`second_strength`; PMIS with
        hypre's CF_init 3, HMIS with S2-isolated points kept C), the
        combined CF marker, multipass interpolation on A; with 1 the
        two-stage product P1 P2 through the intermediate Galerkin
        operator; either truncated by agg_trunc_factor /
        agg_P_max_elmts.  Else interp_type, truncated by trunc_factor /
        P_max_elmts.  Then post_interp_type Jacobi steps."""
        o = self.opts
        agg = len(self._host_A) < o.agg_num_levels
        interp = _INTERP[o.interp_type]
        if agg and o.agg_interp_type == 4:
            S2 = second_strength(S, cf, o.num_paths)
            if o.coarsen_type == "pmis":
                cf2 = pmis_coarsen(S2, seed=o.seed, isolated_to_c=True)
            else:
                cf2 = _COARSEN[o.coarsen_type](S2, A, o.seed)
                if o.coarsen_type == "hmis":
                    # measure_type + 3 keeps S2-isolated points coarse
                    # (par_coarsen.c:960, 1141)
                    cf2 = np.where(np.diff(S2.indptr) == 0, 1, cf2)
            if 0 < (cf2 > 0).sum() < (cf > 0).sum():
                cf = _combine_cf(cf, cf2)
            P = truncate_interp(multipass_interp(A_si, S, cf),
                                o.agg_trunc_factor, o.agg_P_max_elmts)
        elif agg:
            P = P1 = truncate_interp(interp(A_si, S, cf),
                                     o.trunc_factor, o.P_max_elmts)
            A_mid = galerkin_rap(A, P1)
            S2 = strength_matrix(A_mid, o.strong_threshold, o.max_row_sum)
            # CR relaxes on the level's own A, as the JAX package's
            # _coarsen does here
            cf2 = _COARSEN[o.coarsen_type](S2, A, o.seed)
            if 0 < (cf2 > 0).sum() < A_mid.shape[0]:
                P2 = truncate_interp(interp(A_mid, S2, cf2),
                                     o.trunc_factor, o.P_max_elmts)
                P = truncate_interp((P1 @ P2).tocsr(), o.agg_trunc_factor,
                                    o.agg_P_max_elmts)
                cf = _combine_cf(cf, cf2)
        else:
            P = truncate_interp(interp(A_si, S, cf),
                                o.trunc_factor, o.P_max_elmts)
        if o.post_interp_type > 0:
            P = jacobi_interp(A_si, P, cf, o.post_interp_type,
                              o.jacobi_trunc_threshold)
        return P, cf

    def _apply_mult_additive_P(self) -> None:
        """mult_additive / simple: the solve-phase P of the levels in
        [mult_addlvl, add_end] becomes C^ns P, C = I - D^{-1} A (D the
        l1 row norms for add_rlx 18, diag / add_rlx_wt for 0;
        par_amg_setup.c:2485-2665 hypre_CreateC), then truncated
        (hypre_BoomerAMGTruncandBuild).  The coarse operators keep the
        Galerkin product of the original P; R = P^T follows at freeze,
        and an AIR R stays as it was (hypre's R_array)."""
        o = self.opts
        maddlvl = max(o.mult_additive, o.simple)
        if maddlvl < 0:
            return
        L = len(self._host_A)
        add_end = L - 2 if o.add_last_lvl < 0 else min(o.add_last_lvl, L - 2)
        ns = o.num_sweeps_down if o.num_sweeps_down is not None else o.num_sweeps
        for l in range(maddlvl, add_end + 1):
            P, A = self._host_P[l], self._host_A[l]
            if o.add_rlx == 0:
                d = A.diagonal() / o.add_rlx_wt
            else:
                d = np.asarray(np.abs(A).sum(axis=1)).ravel()
            dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1.0, d), 0.0)
            Dinv = sp.diags(dinv)
            for _ in range(max(int(ns), 1)):
                P = (P - Dinv @ (A @ P)).tocsr()
            if o.add_P_max_elmts or o.add_trunc_factor:
                P = truncate_interp(P, o.add_trunc_factor, o.add_P_max_elmts)
            P.sort_indices()
            self._host_P[l] = P

    def _build_seq_coarse(self) -> None:
        """seq_threshold's nested coarse solver (gen_redcs_mat.c:131-157):
        a BoomerAMG on the last level's operator inheriting these
        options, on the same device; the coarse solve runs one cycle of
        it (MaxIter 1, Tol 0)."""
        o = self.opts
        Ac = self._host_A[-1]
        if (o.seq_threshold <= 0 or Ac.shape[0] <= o.max_coarse_size
                or len(self._host_A) < 2):
            return
        nested = dataclasses.replace(
            o, seq_threshold=0, device_setup=False, device_rap=False,
            device_coarsen=False, lattice_shape=None, lattice_coeffs=None,
            embed_level1=False, relocate_level2=False,
            additive=-1, mult_additive=-1, simple=-1,
        )
        self._seq_coarse = BoomerAMG(CSRMatrix.from_scipy(Ac.tocsr()), nested,
                                     device=self.device)

    def _device_cf0(self, A) -> Optional[np.ndarray]:
        """With device_coarsen, at level 0 of a lattice operator of few
        diagonals, one function and no GSMG (the JAX package's gate),
        the CF marker by device_pmis on A's f64 DIA table, bitwise
        pmis_coarsen's; else None."""
        o = self.opts
        if (not o.device_coarsen or self._host_A or o.lattice_shape is None
                or o.coarsen_type != "pmis" or o.num_functions > 1 or o.gsmg
                or len(native.dia_offsets_only(A)) > DIA_MAX_OFFSETS):
            return None
        D0 = csr_to_dia(CSRMatrix.from_scipy(A), "float64", self.device)
        cf = device_pmis(D0.data, D0.offsets, A.shape[0], seed=o.seed,
                         theta=o.strong_threshold, max_row_sum=o.max_row_sum)
        return cf.cpu().numpy().astype(np.int64)

    # ------------------------------------------------------------------
    # the device-resident level-0 setup (ops/device_setup.py)
    # ------------------------------------------------------------------
    def _fast_eligible(self, A) -> bool:
        """The JAX package's gate of the device chain."""
        o = self.opts
        if not o.device_setup or o.lattice_shape is None:
            return False
        if o.num_functions > 1 or o.gsmg or o.nodal or o.agg_num_levels:
            return False
        if o.coarsen_type != "pmis" or o.interp_type != "classical":
            return False
        if (o.post_interp_type or o.restrict_type or o.seq_threshold > 0
                or max(o.additive, o.mult_additive, o.simple) >= 0):
            return False
        if not self._jacobi_updown() or o.smooth_num_levels:
            return False
        n, m = A.shape
        if n != m or int(np.prod(o.lattice_shape)) != n or A.nnz == 0:
            return False
        if o.max_levels < 3 or n <= o.max_coarse_size:
            return False
        return len(native.dia_offsets_only(A)) <= DIA_MAX_OFFSETS

    def _device_setup_level0(self, A):
        """Strength -> PMIS -> classical interpolation -> RAP of level 0
        on the device, each phase timed (DS_*) with the device
        synchronized; then cf0 and the compact level-1 A go to the host.
        The setup math runs in `dtype`.  Returns the chain's products,
        or None for a degenerate CF marker (the host setup then runs
        level 0 itself)."""
        from ...ops.device_setup import (device_classical_interp, device_rap,
                                         device_row_stats)

        o = self.opts
        dev = self.device
        n = A.shape[0]
        with timed("DS_SHIP_A0", device=dev):
            D0 = None
            if o.lattice_coeffs is not None:
                D0 = device_lattice_dia(o.lattice_shape, o.lattice_coeffs,
                                        o.dtype, dev)
            if D0 is None:
                D0 = csr_to_dia(CSRMatrix.from_scipy(A), o.dtype, dev)
        with timed("DS_PMIS", device=dev):
            cf_dev = device_pmis(D0.data, D0.offsets, n, seed=o.seed,
                                 theta=o.strong_threshold,
                                 max_row_sum=o.max_row_sum)
            cf0 = cf_dev.cpu().numpy().astype(np.int64)
        nc = int((cf0 > 0).sum())
        if nc == 0 or nc == n:
            return None
        with timed("DS_INTERP", device=dev):
            P_data, rowmaxP = device_classical_interp(
                D0.data, cf_dev, offsets=D0.offsets,
                theta=o.strong_threshold, max_row_sum=o.max_row_sum,
                trunc_factor=o.trunc_factor, max_elmts=o.P_max_elmts)
            keepP = np.flatnonzero(rowmaxP.cpu().numpy() > 0)
            P_dia = DIAMatrix(
                data=P_data[torch.from_numpy(keepP).to(dev)],
                offsets=tuple(D0.offsets[k] for k in keepP),
                num_rows=n, num_cols=n)
            del P_data
        with timed("DS_RAP", device=dev):
            A1_data, offs_1 = device_rap(P_dia, D0, tol=self._level_ngt(0))
        A1_dia = DIAMatrix(data=A1_data, offsets=offs_1, num_rows=n,
                           num_cols=n)
        with timed("DS_STATS", device=dev):
            # kept beside the chain's products, as in the JAX package;
            # level 1 takes its dinv / l1inv from the host's compact A1
            dinv1, l1inv1 = device_row_stats(A1_data, offsets=offs_1)

        cpos0 = np.flatnonzero(cf0 > 0).astype(np.int64)
        with timed("DS_A1_PULL", device=dev):
            # one gather: [noff1, nc] is 1.3 GB at 256^3 in f32
            A1c = A1_data[:, torch.from_numpy(cpos0).to(dev)].cpu().numpy()
        with timed("DS_A1_REBUILD"):
            # coarse CSR from the diagonals.  rank[g] = coarse index of fine
            # row g; for a coarse row i the targets i + off ascend with
            # off, so flattening the [nc, noff1] transpose row-major gives
            # canonical (sorted, duplicate-free) CSR with no sort pass
            rank = np.full(n, -1, dtype=np.int32)
            rank[cpos0] = np.arange(nc, dtype=np.int32)
            offs_arr = np.asarray(offs_1, dtype=np.int64)
            tgt = cpos0[None, :] + offs_arr[:, None]        # [noff1, nc]
            inb = (tgt >= 0) & (tgt < n)
            pos_c = rank[np.where(inb, tgt, 0)]
            sel = inb & (pos_c >= 0) & (A1c != 0)
            selT = sel.T
            indptr = np.zeros(nc + 1, dtype=np.int32)
            indptr[1:] = np.cumsum(selT.sum(axis=1), dtype=np.int64)
            flat = selT.ravel()
            A1_host = sp.csr_matrix(
                (A1c.T.ravel()[flat].astype(np.float64),
                 pos_c.T.ravel()[flat].astype(np.int32), indptr),
                shape=(nc, nc))
            A1_host.has_sorted_indices = True
        return dict(D0=D0, P=P_dia, A1=A1_dia, cf0=cf0, cpos0=cpos0,
                    A1_host=A1_host, dinv1=dinv1, l1inv1=l1inv1)

    def _host_P0(self):
        """The device chain's level-0 P as a host scipy CSR (fine rows x
        coarse columns), made on first request."""
        if self._host_P[0] is not None or self._fast is None:
            return self._host_P[0]
        f = self._fast
        P = f["P"]
        n = P.num_rows
        cpos0 = f["cpos0"]
        data = P.data.cpu().numpy()
        rows_l, cols_l, vals_l = [], [], []
        for k, off in enumerate(P.offsets):
            tgt = np.arange(n, dtype=np.int64) + int(off)
            pos = np.searchsorted(cpos0, np.clip(tgt, 0, None))
            pos_c = np.minimum(pos, len(cpos0) - 1)
            valid = (tgt >= 0) & (tgt < n) & (cpos0[pos_c] == tgt)
            v = data[k]
            sel = valid & (v != 0)
            rows_l.append(np.flatnonzero(sel))
            cols_l.append(pos_c[sel])
            vals_l.append(v[sel].astype(np.float64))
        Ph = sp.csr_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(n, len(cpos0)))
        Ph.sum_duplicates()
        Ph.sort_indices()
        self._host_P[0] = Ph
        return Ph

    def _host_R_or_PT(self, l: int):
        """Host scipy R of level l: the AIR restriction, else P^T."""
        R = self._host_R[l]
        return self.host_P(l).T.tocsr() if R is None else R

    def host_P(self, l: int):
        """Host scipy P of level l (the device chain's level-0 P is made
        on first request)."""
        if l == 0 and self._host_P and self._host_P[0] is None:
            return self._host_P0()
        return self._host_P[l]

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
        once into its final form on the device (the device chain's
        level-0 / level-1 forms installed as they are), then collapse
        the coarse sub-cycle."""
        L = len(self._host_A)
        fast = self._fast is not None
        # the device chain embeds level 1 on the fine lattice always
        cpos0 = self._fast["cpos0"] if fast else self._plan_embed()
        reloc = self._plan_reloc(cpos0) if cpos0 is not None else []
        # forms the lattice build steps replace are never frozen
        skip_A = {1} if cpos0 is not None else set()
        skip_PR = {0} if cpos0 is not None else set()
        if fast:
            skip_A.add(0)  # the device chain's DIA table
        for ent in reloc:
            skip_A.add(ent["k"])
            skip_PR.add(ent["k"] - 1)
        with timed("FREEZE", device=self.device):
            for k in range(L):
                coarsest = k == L - 1
                transfers = not coarsest and k not in skip_PR
                self.levels.append(self._freeze_level(
                    self._host_A[k],
                    self._host_P[k] if transfers else None,
                    self._host_R[k] if transfers else None,
                    None if coarsest else self._cf[k],
                    fine=(k == 0), coarsest=coarsest, skip_A=k in skip_A,
                ))
            will_reloc_l2 = any(ent["k"] == 2 for ent in reloc)
            if fast:
                self._install_fast_levels(will_reloc_l2)
            elif cpos0 is not None:
                self._build_embed_level1(cpos0, will_reloc_l2)
            if reloc:
                self._build_relocated(reloc)
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

    def _freeze_level(self, A, P, R, cf, fine: bool, coarsest: bool,
                      skip_A: bool = False) -> AMGLevel:
        """dinv, l1inv and the coarsest pinv are computed in numpy f64
        and then cast.  The fine A keeps `dtype` (it defines the
        residual PCG minimizes); coarse A, P and R use `mat_dtype`.  R
        None means P^T.  skip_A, and P None above the coarsest level,
        leave out forms a lattice build step replaces."""
        o = self.opts
        dev = self.device
        dt = torch_dtype(o.dtype)
        n = A.shape[0]
        dinv, l1inv = self._inverses(A)
        coarse_inv = None
        if coarsest and self._seq_coarse is None:
            coarse_inv = to_device(
                np.linalg.pinv(A.toarray(), rcond=1e-12), dt, dev)
        if skip_A:
            A_frozen = None
        elif fine:
            A_frozen = freeze_auto(CSRMatrix.from_scipy(A), dt, dev)
        else:
            A_frozen = self._freeze_compact(A)
        if coarsest:
            relax_types = ({int(o.grid_relax_type[3])}
                           if o.grid_relax_type is not None
                           else {o.relax_coarse})
        else:
            relax_types = _updown_relax_types(o)
        gs_fwd = gs_bwd = cheby = None
        if not coarsest and relax_types & set(_GS_TYPES):
            with timed("GS_SCHEDULE", device=dev):
                gs_fwd, gs_bwd = self._gs_schedules(A, cf)
        if not coarsest and 16 in relax_types:
            cheby = cheby_setup(CSRMatrix.from_scipy(A), o.cheby_order,
                                o.cheby_ratio, device=dev)
        euclid = schwarz = parasails = None
        # the levels being frozen in order: len(self.levels) is this
        # level's (the transposed hierarchy, frozen later, takes none,
        # as in the JAX package)
        if not coarsest and len(self.levels) < o.smooth_num_levels:
            with timed("SMOOTHER_SETUP", device=dev):
                euclid, schwarz, parasails = self._complex_smoother(A)
        return AMGLevel(
            A=A_frozen,
            dinv=to_device(dinv, dt, dev),
            l1inv=to_device(l1inv, dt, dev),
            cmask=torch.from_numpy(
                cf > 0 if cf is not None else np.zeros(n, bool)).to(dev),
            P=None if P is None else self._freeze_compact(P),
            R=None if P is None else self._freeze_compact(
                P.T.tocsr() if R is None else R),
            coarse_inv=coarse_inv,
            gs_fwd=gs_fwd,
            gs_bwd=gs_bwd,
            cheby=cheby,
            euclid=euclid, schwarz=schwarz, parasails=parasails,
        )

    def _complex_smoother(self, A):
        """(euclid, schwarz, parasails) of a level: the one smooth_type
        names, built from its host A with the JAX package's options
        (par_cycle.c's smooth_type 9 Euclid, 6 Schwarz (RAS over row
        blocks), 8 ParaSails (FSAI)); ParaSails' factors frozen in
        mat_dtype."""
        o = self.opts
        if o.smooth_type == 9:
            return build_euclid(A, num_domains=o.euclid_domains,
                                fill_level=o.euclid_fill,
                                colored=o.euclid_colored,
                                device=self.device), None, None
        Ah = CSRMatrix.from_scipy(A)
        if o.smooth_type == 6:
            return None, build_schwarz_data(Ah, SchwarzOptions(),
                                            device=self.device), None
        if o.smooth_type == 8:
            return None, None, build_parasails_data(
                Ah, ParaSailsOptions(), device=self.device,
                dtype=o.mat_dtype or o.dtype)
        return None, None, None

    def _gs_schedules(self, A, cf):
        """(forward, backward) GS schedules of a host level, sharing one
        GSMatrix on the device; each a (C, F) pair of masked schedules
        with relax_order 1 (par_cycle.c:398) or C / F point sweeps in
        grid_relax_points.  The divisor is the diagonal, 1 where it is
        0: option-4's l1 divisor degenerates to |diag| on one partition,
        the sign following the diagonal (ams.c:642-660)."""
        Ah = CSRMatrix.from_scipy(A)
        diag = A.diagonal()
        gs_div = np.where(diag == 0, 1.0, diag)
        mat = GSMatrix.build(Ah, gs_div, self.device)

        def build(forward, mask=None):
            return build_gs_schedule(Ah, forward, gs_div, mask=mask,
                                     device=self.device, mat=mat)

        o = self.opts
        point_sweeps = o.grid_relax_points is not None and any(
            p for pos in o.grid_relax_points for p in pos)
        if (o.relax_order == 1 or point_sweeps) and cf is not None:
            cm = cf > 0
            return ((build(True, cm), build(True, ~cm)),
                    (build(False, cm), build(False, ~cm)))
        return build(True), build(False)

    # ------------------------------------------------------------------
    # the lattice forms (host planning, device build)
    # ------------------------------------------------------------------
    def _jacobi_updown(self) -> bool:
        """The lattice levels and the device chain smooth with the
        Jacobi family only, and without C / F point sweeps."""
        o = self.opts
        return (not (_updown_relax_types(o) - {0, 7, 18})
                and o.grid_relax_points is None)

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
            innerR = self._freeze_compact(self._host_R_or_PT(k))
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
        if o.restrict_type > 0:
            # the embedding (and the relocation after it) builds level
            # 0's R from P^T; the JAX package embeds anyway and so drops
            # AIR's R there.  The port keeps R on the compact forms
            return None
        if not self._jacobi_updown():
            return None  # embedded smoothing is for the Jacobi family only
        if o.smooth_num_levels > 0:
            return None  # the complex smoothers work on the compact layout
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
        branch) level-0 R is the device transpose of the embedded P
        (bitwise the host-built one) and level-1 A the device pass over
        the fine A and the embedded P (ops/device_rap.py), timed as
        DEVICE_RAP; otherwise, and when level 0's P was smoothed for the
        cycle, both are built from the host values."""
        o = self.opts
        mdt = torch_dtype(o.mat_dtype or o.dtype)
        dev = self.device
        n0 = self._host_A[0].shape[0]
        A1, P0 = self._host_A[1], self._host_P[0]
        idx = np.arange(n0, dtype=np.int64)
        P0e = build_embedded_dia(P0, idx, cpos0, n0, mdt, dev)
        # the device pass forms R A P over the cycle's P0; once
        # mult_additive / simple has smoothed that P, level 1 must stay
        # the Galerkin product of the original one, so it comes from
        # the host (the JAX package's device pass takes the smoothed P)
        if (o.device_rap and self._host_A1_unf is not None
                and max(o.mult_additive, o.simple) != 0):
            p = self._device_rap_plan(cpos0)
            with timed("DEVICE_RAP", device=dev):
                R0e = dia_transpose_device(P0e)
                data, _, _ = embedded_rap_device(P0e, self.levels[0].A,
                                                 p["plan"], p["tol"], p["mdt"])
            A_emb = DIAMatrix(data=data, offsets=p["offsets"], num_rows=n0,
                              num_cols=n0)
        else:
            R0e = build_embedded_dia(P0.T.tocsr(), cpos0, idx, n0, mdt, dev)
            A_emb = build_embedded_dia(A1, cpos0, cpos0, n0, mdt, dev)
        self.levels[0] = dataclasses.replace(self.levels[0], P=P0e, R=R0e)
        self._embed_level1(A_emb, cpos0, will_reloc_l2)

    def _embed_level1(self, A_emb, cpos0, will_reloc_l2: bool) -> None:
        """Level 1 on the fine lattice: A_emb; dinv / l1inv / cmask at
        cpos0, host-exact from the compact A1 (f64, then cast); its
        transfers the compact frozen P1 / R1 behind scatter / gather,
        unless the relocation of level 2 replaces them with parity
        operators."""
        n0 = self._host_A[0].shape[0]
        dinv_e, l1inv_e, cmask_e = self._embedded_level_vectors(
            self._host_A[1], self._cf[1], cpos0, n0)
        new_P = new_R = None
        if self._host_P[1:] and not will_reloc_l2:
            new_P, new_R = self._wrap_compact_transfers(
                1, self.levels[1], cpos0, n0)
        self.levels[1] = dataclasses.replace(
            self.levels[1], A=A_emb, dinv=dinv_e, l1inv=l1inv_e,
            cmask=cmask_e, P=new_P, R=new_R,
        )

    def _install_fast_levels(self, will_reloc_l2: bool) -> None:
        """Install the device chain's level-0 / level-1 forms (the
        device_setup counterpart of _build_embed_level1): the fine DIA
        table in `dtype`, P0 in `mat_dtype` with R0 its device
        transpose, the embedded A1 in `mat_dtype`.  The chain's A1 and
        D0 are then dropped, so the card does not hold both them and the
        levels' cast copies; its P stays for host_P(0)."""
        f = self._fast
        mdt = torch_dtype(self.opts.mat_dtype or self.opts.dtype)
        P0 = dataclasses.replace(f["P"], data=f["P"].data.to(mdt))
        self.levels[0] = dataclasses.replace(
            self.levels[0], A=f["D0"], P=P0, R=dia_transpose_device(P0))
        A1 = dataclasses.replace(f["A1"], data=f["A1"].data.to(mdt))
        self._embed_level1(A1, f["cpos0"], will_reloc_l2)
        f["A1"] = f["D0"] = None

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
                if o.relocate_offset_budget > 0:
                    cnt = min(cnt, o.relocate_offset_budget)
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
            if o.transfer_offset_budget > 0:
                # the budget plus the rows' rescue entries (each row
                # that would empty keeps its largest entry)
                pr_offs = min(pr_offs, 2 * o.transfer_offset_budget)
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
                if o.relocate_offset_budget > 0:
                    A_k = offset_budget_filter(A_k, rcell,
                                               o.relocate_offset_budget,
                                               lump=o.relocate_lump)
                A_new = build_embedded_dia(A_k, rcell, rcell, ncells, mdt, dev,
                                           tail_min=tmin)
            else:
                # dense core behind one gather / scatter
                dense = DenseMatrix(data=to_device(A_k.toarray(), mdt, dev),
                                    num_rows=n_k, num_cols=n_k)
                A_new = self._on_cells(dense, rcell, ncells)
            # parity transfer operators between lattice k-1 and k
            if o.transfer_offset_budget > 0:
                Pf = parity_offset_budget_filter(Pf, rcell, lat_shape, factors,
                                                 o.transfer_offset_budget)
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
            A, P, R = dense(Ah), dense(Ph), dense(self._host_R_or_PT(l))
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
    # statistics (par_stats.c)
    # ------------------------------------------------------------------
    @property
    def num_levels(self) -> int:
        """The setup hierarchy's depth (par_stats.c "Number of levels");
        the frozen hierarchy is shorter where the coarse sub-cycle was
        collapsed."""
        return len(self._host_A)

    @property
    def num_frozen_levels(self) -> int:
        return len(self.levels)

    def grid_complexity(self) -> float:
        n0 = self._host_A[0].shape[0]
        return sum(a.shape[0] for a in self._host_A) / n0

    def operator_complexity(self) -> float:
        nnz0 = self._host_A[0].nnz
        return sum(a.nnz for a in self._host_A) / nnz0

    def cycle_complexity(self) -> float:
        """nnz-weighted work of a V-cycle relative to the fine nnz, the
        JAX package's formula: num_sweeps down and up a level (twice
        with relax_order 1), the coarsest level once."""
        o = self.opts
        nnz0 = self._host_A[0].nnz
        sweeps = 2 * o.num_sweeps * (2 if o.relax_order == 1 else 1)
        last = len(self._host_A) - 1
        return sum(a.nnz * (1 if l == last else sweeps)
                   for l, a in enumerate(self._host_A)) / nnz0

    # ------------------------------------------------------------------
    # cycle (device)
    # ------------------------------------------------------------------
    def _relax_plan(self, cycle_param: int):
        """(relax_type, points of each sweep) at a cycle position:
        0 the finest level's down sweeps, 1 down, 2 up, 3 the coarsest
        (par_cycle.c:288/333 grid_relax_type[cycle_param] and
        grid_relax_points[cycle_param][j]); the scalar options fill in
        where the old-style arrays are unset.  points: 0 all, 1 C, -1 F."""
        o = self.opts
        if o.grid_relax_type is not None:
            rt = int(o.grid_relax_type[cycle_param])
        elif cycle_param == 3:
            rt = o.relax_coarse
        else:
            rt = o.relax_down if cycle_param in (0, 1) else o.relax_up
        if o.grid_relax_points is not None:
            return rt, tuple(int(p) for p in o.grid_relax_points[cycle_param])
        if cycle_param == 3:
            ns = (o.num_sweeps_coarse or o.num_sweeps) if rt != 9 else 1
        else:
            ns = (o.num_sweeps_down if cycle_param in (0, 1)
                  else o.num_sweeps_up) or o.num_sweeps
        return rt, (0,) * ns

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
                level: int, u_zero: bool = False, points: int = 0):
        """One relaxation call.  u_zero: the caller guarantees u == 0
        (the first down-smooth of every level inside a preconditioner
        cycle); Jacobi sweeps then skip the A @ 0 matvec with a
        bitwise-identical result.  The other smoothers ignore it, as in
        the JAX package (GS sweeps the zero vector).  points: 0 all, 1
        only the C points, -1 only the F points (grid_relax_points)."""
        w = self._level_weight(level)
        if relax_type == 9:
            ci = lvl.coarse_inv
            if ci is None:
                # seq_threshold: one cycle of the nested BoomerAMG
                # (gen_redcs_mat.c hypre_seqAMGCycle, MaxIter 1)
                return self._seq_coarse.cycle(f)
            # the dense pinv, or the collapsed sub-cycle as an operator
            return ci @ f if isinstance(ci, torch.Tensor) else spmv(ci, f)
        # the complex smoother replaces relaxation on its levels
        # (par_cycle.c's smooth_num_levels branch), in the JAX package's
        # order
        matvec = lambda v: spmv(lvl.A, v)  # noqa: E731
        if lvl.euclid is not None:
            return euclid_smooth(lvl.euclid, matvec, u, f, w)
        if lvl.schwarz is not None:
            return schwarz_smooth(lvl.schwarz, matvec, u, f, w)
        if lvl.parasails is not None:
            return parasails_smooth(lvl.parasails, matvec, u, f, w)
        if relax_type not in _JACOBI:
            return self._smooth_other(lvl, relax_type, u, f, up, level, w,
                                      points)
        # 0/7 weighted Jacobi; 5 chaotic GS (== Jacobi on a data-parallel
        # machine); 18 l1-Jacobi
        div = lvl.l1inv if relax_type == 18 else lvl.dinv
        if points:
            # a grid_relax_points sweep (par_relax.c relax_points: update
            # only C (+1) or F (-1) points)
            mask = lvl.cmask if points == 1 else ~lvl.cmask
            if u_zero:
                return torch.where(mask, w * div * f, 0.0)
            return jacobi_cf(lvl.A, div, u, f, mask, w)
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
                      level: int, w: float, points: int):
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
            return self._gs(lvl.gs_fwd, u, f, w, up, points, omega=om)
        if relax_type in (4, 14):
            return self._gs(lvl.gs_bwd, u, f, w, up, points,
                            omega=self._level_omega(level))
        if relax_type in (6, 8):
            # hybrid SSOR / L1-SSOR (same degenerate divisor at np=1).
            # ONE Vtemp copy per Relax call (par_relax.c:3148): the
            # backward half-sweep's S_pre uses the pre-FORWARD iterate.
            om = self._level_omega(level)
            v0 = u if om != 1.0 else None
            u = self._gs(lvl.gs_fwd, u, f, w, up, points, omega=om, v=v0)
            return self._gs(lvl.gs_bwd, u, f, w, up, points, omega=om, v=v0)
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
    def _gs(sched, u, f, w, up, points: int = 0, omega: float = 1.0, v=None):
        """One GS relaxation call: a sweep of `sched`, or with a (C, F)
        pair down C then F, up F then C (par_cycle.c:398), each half-sweep
        its own hypre Relax call (a fresh Vtemp unless the caller pinned
        one: SSOR); a grid_relax_points sweep runs just the half it
        names."""
        if isinstance(sched, tuple):
            sc, sf = sched
            if points:
                return gauss_seidel(sc if points == 1 else sf, u, f, w,
                                    omega=omega, v=v)
            for sd in ((sf, sc) if up else (sc, sf)):
                u = gauss_seidel(sd, u, f, w, omega=omega, v=v)
            return u
        if points:
            # only on a level built without a CF split: every level with
            # one gets (C, F) schedule pairs when point sweeps are set.
            # The reference cannot run this either: a nonzero
            # relax_points with a NULL CF_marker dereferences it
            # (par_relax.c:109)
            raise NotImplementedError(
                "grid_relax_points with GS relaxation on a level with no "
                "CF split (the coarsest); use 0 (all points) there")
        return gauss_seidel(sched, u, f, w, omega=omega, v=v)

    def _additive(self) -> bool:
        o = self.opts
        return max(o.additive, o.mult_additive, o.simple) >= 0

    def _mult_steps(self, L: int, fine_u_zero: bool, top_counter: int = 1):
        """hypre's nonrecursive cycle state machine (par_cycle.c:255-621)
        over L levels, as the steps `_run` executes (see `_run`):
        lev_counter drives the V / W revisits (cycle_type), fcycle_lev
        the F-cycle.  With cycle_type 1 and no fcycle this is the
        V-cycle.  fine_u_zero: the incoming u is exactly zero.
        top_counter: the first level's descents, when these levels are
        the replicated tail of a sharded hierarchy whose top is a
        mid-hierarchy level (a W-cycle descends cycle_type times there;
        parallel/par_amg.py)."""
        o = self.opts
        if L == 1:
            yield "smooth", 0, o.relax_coarse, (0,), False, False
            return
        uz = [False] * L  # U[level] is exactly zero
        uz[0] = fine_u_zero
        lev_counter = ([top_counter]
                       + [1 if o.fcycle else o.cycle_type] * (L - 1))
        fcycle_lev = L - 2
        level, cycle_param = 0, 0
        while True:
            rt, pts = self._relax_plan(cycle_param)
            coarsest = cycle_param == 3
            # the coarsest solve gets no u_zero shortcut
            yield ("smooth", level, rt, pts, cycle_param == 2,
                   uz[level] and not coarsest)
            if coarsest or pts:
                uz[level] = False
            lev_counter[level] -= 1
            if lev_counter[level] >= 0 and level != L - 1:
                yield "restrict", level, True
                level += 1
                uz[level] = True
                lev_counter[level] = max(lev_counter[level], o.cycle_type)
                cycle_param = 1 if level < L - 1 else 3
            elif level != 0:
                yield "prolong", level - 1
                level -= 1
                cycle_param = 2
                if o.fcycle and fcycle_lev == level:
                    lev_counter[level] = max(lev_counter[level], 1)
                    fcycle_lev -= 1
            else:
                return

    def _add_steps(self, L: int, fine_u_zero: bool):
        """hypre_BoomerAMGAdditiveCycle (par_add_cycle.c:22) over L
        levels, as the steps `_run` executes.  Levels in [addlvl,
        add_end] are additive: the down pass restricts the raw F (exact
        as a preconditioner, where u == 0), the band's corrections are
        applied together ("band") and summed through the up pass.
        Levels outside the band run the multiplicative V steps with
        relax_down / relax_up / relax_coarse."""
        o = self.opts
        # a start level past the hierarchy still smooths the coarsest
        # additively (no direct solve exists in this cycle)
        addlvl = min(max(o.additive, o.mult_additive, o.simple), L - 1)
        add_end = L - 1 if o.add_last_lvl < 0 else min(o.add_last_lvl, L - 1)
        ns_down = o.num_sweeps_down or o.num_sweeps
        ns_up = o.num_sweeps_up or o.num_sweeps
        ns_coarse = o.num_sweeps_coarse or o.num_sweeps
        uz = [False] * L
        uz[0] = fine_u_zero
        for l in range(L - 1):
            band = addlvl <= l <= add_end
            if not band:
                yield "smooth", l, o.relax_down, (0,) * ns_down, False, uz[l]
                uz[l] = False
            yield "restrict", l, not band
            uz[l + 1] = True
        for l in range(addlvl, min(add_end, L - 1) + 1):
            yield "band", l, uz[l]
            uz[l] = False
        if add_end < L - 1:
            yield ("smooth", L - 1, o.relax_coarse, (0,) * ns_coarse, False,
                   uz[L - 1])
        for l in range(L - 2, -1, -1):
            yield "prolong", l
            if l + 1 <= addlvl or l + 1 > add_end + 1:
                yield "smooth", l, o.relax_up, (0,) * ns_up, True, False

    def _band_correction(self, lvl: AMGLevel, r):
        """The additive band's smoother applied to r: Lambda r = D (2r -
        A D r), the symmetrized two-sweep Jacobi of CreateLambda, with
        the num_sweeps_down > 1 Neumann step r <- 2r - A Lambda r
        first; `simple`: D r (CreateDinv).  D is 1 / the l1 row norms
        for add_rlx 18, add_rlx_wt / a_ii for 0."""
        o = self.opts
        d = o.add_rlx_wt * lvl.dinv if o.add_rlx == 0 else lvl.l1inv
        if o.simple >= 0:
            return d * r
        if (o.num_sweeps_down or o.num_sweeps) > 1:
            r = spmv_resid(lvl.A, d * spmv_resid(lvl.A, d * r, 2.0 * r),
                           2.0 * r)
        return d * spmv_resid(lvl.A, d * r, 2.0 * r)

    def _run(self, levels, steps, u, f):
        """Execute a cycle's steps (`_mult_steps`, `_add_steps`) on the
        frozen `levels`:
          ("smooth", l, relax_type, points, up, u_zero): one relaxation
              call a sweep, points[j] the class sweep j updates; u_zero:
              U[l] is exactly zero before the first;
          ("restrict", l, resid): F[l+1] = R (F[l] - A U[l]), or with
              resid False R F[l] (the additive band); U[l+1] = 0;
          ("band", l, u_zero): U[l] += the band's correction;
          ("prolong", l): U[l] += P U[l+1].
        The residual and the prolongation are K1's / the ELL kernel's
        fused forms."""
        L = len(levels)
        U, F = [None] * L, [None] * L
        U[0], F[0] = u, f
        for step in steps:
            kind, l = step[0], step[1]
            lvl = levels[l]
            if kind == "smooth":
                _, _, rt, pts, up, u_zero = step
                for j, p in enumerate(pts):
                    U[l] = self._smooth(lvl, rt, U[l], F[l], up, l,
                                        u_zero=u_zero and j == 0, points=p)
            elif kind == "restrict":
                r = spmv_resid(lvl.A, U[l], F[l]) if step[2] else F[l]
                F[l + 1] = spmv(lvl.R, r)
                U[l + 1] = torch.zeros_like(F[l + 1])
            elif kind == "band":
                c = self._band_correction(lvl, F[l])
                U[l] = c if step[2] else U[l] + c
            else:
                U[l] = spmv_axpy(lvl.P, U[l + 1], U[l])
        return U[0]

    def _sweep_launches(self, lvl: AMGLevel, relax_type: int, point: int,
                        u_zero: bool) -> dict:
        """{kernel name: launches} of one `_smooth` call."""
        from ...ops.dia import kernel_launches

        if relax_type == 9:
            ci = lvl.coarse_inv
            if ci is None:
                return self._seq_coarse.cycle_launches()
            return {} if isinstance(ci, torch.Tensor) else kernel_launches(ci)
        A = kernel_launches(lvl.A)
        if lvl.euclid is not None:
            # a residual and the triangular pair, once a color (or once)
            k = lvl.euclid.ncolors if lvl.euclid.colored else 1
            return {**{n: k * c for n, c in A.items()}, "gs_sweep": 2 * k}
        if lvl.schwarz is not None:
            return A  # the residual (the block product is torch's)
        if lvl.parasails is not None:
            ps = lvl.parasails
            out = dict(A)
            for M in ((ps.G, ps.GT) if ps.G is not None else (ps.M,)):
                for n, c in kernel_launches(M).items():
                    out[n] = out.get(n, 0) + c
            return out
        if relax_type in _GS_TYPES:
            calls = 2 if relax_type in (6, 8) else 1
            halves = 2 if isinstance(lvl.gs_fwd, tuple) and not point else 1
            return {"gs_sweep": calls * halves}
        if relax_type in _JACOBI:
            halves = 2 if self.opts.relax_order == 1 and not point else 1
            n = halves - (1 if u_zero else 0)
        elif relax_type == 16:
            n = lvl.cheby.order
        else:
            n = {15: 4, 17: 3}[relax_type]
        return {k: n * c for k, c in A.items()}

    def cycle_launches(self, levels=None, from_zero: bool = True) -> dict:
        """{kernel name: launches} of one `cycle` over `levels` (this
        instance's by default) from a zero initial guess (the PCG
        preconditioner's), or with from_zero False of one `solve`
        cycle (multiplicative, from a guess), found by walking the
        cycle's own steps (`_mult_steps` / `_add_steps`) with the
        launches of each: the smoothing matvecs and GS sweeps
        ("gs_sweep", one launch a sweep of a level), each residual,
        restriction, prolongation and band correction, the coarse solve
        where it is an operator or the nested cycle of seq_threshold
        (ops/dia.py::kernel_launches gives an operator's)."""
        levels = self.levels if levels is None else levels
        if from_zero and self._additive():
            steps = self._add_steps(len(levels), True)
        else:
            steps = self._mult_steps(len(levels), from_zero)
        return self.steps_launches(levels, steps)

    def steps_launches(self, levels, steps) -> dict:
        """{kernel name: launches} of `_run(levels, steps, ...)`."""
        from ...ops.dia import kernel_launches

        out: dict = {"gs_sweep": 0}

        def add(counts: dict, k: int = 1):
            for name, c in counts.items():
                out[name] = out.get(name, 0) + k * c

        for step in steps:
            kind, l = step[0], step[1]
            lvl = levels[l]
            if kind == "smooth":
                _, _, rt, pts, _, u_zero = step
                for j, p in enumerate(pts):
                    add(self._sweep_launches(lvl, rt, p, u_zero and j == 0))
            elif kind == "restrict":
                if step[2]:
                    add(kernel_launches(lvl.A))
                add(kernel_launches(lvl.R))
            elif kind == "band":
                if self.opts.simple < 0:
                    o = self.opts
                    add(kernel_launches(lvl.A),
                        3 if (o.num_sweeps_down or o.num_sweeps) > 1 else 1)
            else:
                add(kernel_launches(lvl.P))
        return out

    def cycle(self, f, u=None, levels=None):
        """One cycle (par_cycle.c; the additive cycle when additive,
        mult_additive or simple is set) over `levels`, this instance's
        by default.  With u None the initial guess is zero and the first
        down-smooths skip their A @ 0 matvecs."""
        levels = self.levels if levels is None else levels
        steps = (self._add_steps if self._additive() else self._mult_steps)(
            len(levels), u is None)
        return self._run(levels, steps, torch.zeros_like(f) if u is None
                         else u, f)

    def _vcycle(self, levels, u, f):
        """One multiplicative cycle from the guess u (`solve`'s)."""
        return self._run(levels, self._mult_steps(len(levels), False), u, f)

    @property
    def precond(self):
        """M(r) -> z: one cycle with zero initial guess (the PCG hook)."""
        return lambda r: self.cycle(r)

    # ------------------------------------------------------------------
    # transpose solve (par_amg_solve.c hypre_BoomerAMGSolveT)
    # ------------------------------------------------------------------
    @property
    def levels_T(self) -> list:
        """The frozen transposed hierarchy, made on first request: A^T on
        every level, interpolating with R^T and restricting with P^T
        (with R = P^T the forward transfers), the l1 norms and GS
        schedules those of A^T.  It equals the forward hierarchy for
        symmetric A and R = P^T; SolveT serves the nonsymmetric ones and
        AIR's R != P^T."""
        if self._levels_T is None:
            L = len(self._host_A)
            with timed("FREEZE_T", device=self.device):
                self._levels_T = [self._freeze_level(
                    self._host_A[k].T.tocsr(), *self._transfers_T(k),
                    None if k == L - 1 else self._cf[k],
                    fine=k == 0, coarsest=k == L - 1) for k in range(L)]
        return self._levels_T

    def _transfers_T(self, k: int):
        """(P, R) of level k in the transposed hierarchy: (R^T, P^T);
        with R = P^T that is (P, None), the forward transfers."""
        if k == len(self._host_A) - 1:
            return None, None
        R = self._host_R[k]
        if R is None:
            return self.host_P(k), None
        return R.T.tocsr(), self.host_P(k).T.tocsr()

    def cycleT(self, f, u=None):
        """One cycle on A^T (the SolveT preconditioner hook)."""
        return self._vcycle(self.levels_T,
                            torch.zeros_like(f) if u is None else u, f)

    def solveT(self, b, x0=None, tol: float = 1e-7, max_iter: int = 20,
               min_iter: int = 0) -> SolverResult:
        """Iterate transpose cycles until ||b - A^T x|| / ||b|| < tol
        (par_amg_solve.c SolveT)."""
        return self.solve(b, x0=x0, tol=tol, max_iter=max_iter,
                          min_iter=min_iter, levels=self.levels_T)

    # ------------------------------------------------------------------
    # standalone solve (par_amg_solve.c)
    # ------------------------------------------------------------------
    def solve(self, b, x0=None, tol: float = 1e-7, max_iter: int = 20,
              min_iter: int = 0, levels=None) -> SolverResult:
        """Iterate multiplicative cycles over `levels` (this instance's
        by default) until ||r||/||b|| < tol (par_amg_solve.c:243;
        hypre's solver 0).  x0 defaults to zeros of the fine operator's
        dtype.  A Python loop that reads the stop test on the host once
        an iteration, as pcg's does; the residual history lands in a
        NaN-padded [max_iter + 1] tensor."""
        levels = self.levels if levels is None else levels
        A = levels[0].A
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
            x = self._vcycle(levels, x, b)
            r = spmv_resid(A, x, b)
            rnorm = torch.sqrt(torch.dot(r, r))
            i += 1
            norms[i] = rnorm
        rel = rnorm / den
        return SolverResult(x=x, num_iterations=i, rel_residual_norm=rel,
                            converged=bool(rel < tol), res_norms=norms)
