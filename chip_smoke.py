"""Chip smoke test of the PyTorch/CUDA port (hypre_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (csrc/dia_spmv.cu, csrc/ell_spmv.cu,
     csrc/gather.cu, csrc/coo_tail.cu, csrc/cell_dense.cu,
     csrc/gs_sweep.cu; one nvcc each, all at once) and the host setup
     library (csrc/host_kernels.c, cc) from the sources;
  3. hold K1 (the DIA SpMV) against its plain torch version on the card
     at the shapes of the main path and on wide/edge offset sets; time
     both at 96^3, and the cuSPARSE CSR product on the same operator;
     then K1's fused forms (resid, axpy, jacobi) at 96^3 against their
     plain versions, each timed beside the unfused sequence it replaces
     (the plain kernel and torch's elementwise ops);
  4. the gathers (counterparts of the TPU gather probes K2/K3): the
     ptxas report of csrc/gather.cu's tiled instances (0 bytes spilled
     required); the probes' four gathers through the kernels' default
     (tiled) form, counted; both forms bitwise against the plain
     versions there and on a ragged and a too-wide (L2-instance) shape
     for each axis; each probe timed, the tiled and the elementwise
     (earlier) form in turns, beside the empty kernel, the bytes bound,
     the plain version and the library call;
  5. the 24^3 f64 slice on the card against the same on the CPU, with
     the plain forms and with the lattice forms (relocate_min_n2=0, the
     level-1 values from the host branch, device_rap=False);
  6. the slice in float64 at 96^3: BoomerAMG setup, freeze on the card,
     PCG (two-norm, tol 1e-6, b = ones) -- exactly 25 iterations, the
     hypre oracle count, with K1 carrying the fine-level matvecs and the
     ELL kernel every coarse-level and grid-transfer matvec, counted
     exactly; then the ELL
     kernel against its plain version on every ELL operator of that
     hierarchy, each timed beside its floor and the cuSPARSE call, and
     every form of it against its plain version on every operator, the
     forms the V-cycle uses timed beside the unfused sequence;
  7. the same with float32 vectors, bfloat16 matrices and
     nongalerkin_tol 0.02 at 96^3 -- 21 +- 1 iterations;
  8. the lattice path at 96^3 in both configurations: the JAX package's
     own option defaults (level 1 embedded on the fine lattice with its
     values from the device RAP, deeper levels relocated onto cell
     lattices with parity transfers and COO tails, the coarse sub-cycle
     collapsed), lattice_shape given -- 25 and 21 +- 1 iterations
     again, every DIA part
     a K1 launch, every tail riding in a K1 launch, the collapsed coarse
     solve one cell_dense launch, no coo_tail or flat_take launch,
     counted exactly; then K1 with its tail on every tailed operator in
     the forms the cycle runs against the composition it replaced (K1,
     coo_tail, the torch epilogue: bitwise in f64, the restriction to
     1e-13) and against the plain version, timed beside that
     composition; the cell_dense kernel against its plain version,
     timed beside its bound, torch.matmul and the four calls it
     replaced; each lattice operator against its plain evaluation,
     timed beside its bound and one cuSPARSE CSR product; each tail
     (coo_tail, no longer on the path) against its plain version and
     the three-call torch form, and each gather (flat_take) at the
     path's shapes against its plain version, bitwise; then the device
     RAP (`phase_device_rap`): level-1 A against the host product,
     the pass against the host branch's build, and both branches'
     FREEZE seconds (FREEZE includes DEVICE_RAP), one freeze each;
  9. (a) after step 5, `entry()` (hypre_tpu_torch/entry.py: ext+i,
     f32/bf16, the lattice defaults at 24^3) on the card and on the CPU,
     the same residual norm, the launches exactly as the hierarchy says;
     (c) extended+i interpolation: at 48^3 f64 on the plain forms the
     JAX package's count; at 96^3, f64 and f32/bf16, the plain forms and
     the lattice forms with the device RAP, the same count (f32/bf16:
     within one), each with its levels, gates, setup phases, device busy
     time and kernels an iteration.  After each run of (a) and (c) every
     operator of its hierarchy, in the forms the cycle runs it, through
     the kernels against its plain version (`phase_hold_operators`);
 10. the Gauss-Seidel family (relax 13 / 14, the BoomerAMGOptions()
     defaults; the gs_sweep kernel, csrc/gs_sweep.cu, built with the
     others): t_step, one cross-SM step of the sync-free sweep, by a
     two-SM ping-pong probe (and the flag design's step beside it); at
     96^3 in f64 and in f32/bf16/ngt 0.02, the JAX package's counts
     (GS96_F64, GS96_F32) with gs_sweep (every sweep in the sync-free
     form), K1 and the ELL kernel launched exactly as the hierarchy says
     (`BoomerAMG.cycle_launches`: 14 sweeps a V-cycle), setup phases
     with the schedules' seconds and bytes, device busy and kernels an
     iteration; every f64 schedule's sync-free sweep against its plain
     version in the plain and omega forms and bitwise the wavefront
     form (one block and grid), each level's sweep timed in both forms
     beside its bytes bound, its latency bound (wavefronts x t_step),
     its wavefronts, the plain version and the cuSPARSE SpMV +
     triangular solve; the f32 schedules held; the C / F halves of
     relax_order 1 at 24^3 and a nonsymmetric matrix with hazard
     wavefronts, bitwise the wavefront form too; BoomerAMGOptions() at
     24^3 and Chebyshev (relax 16) at 48^3 f64, card against CPU: the
     same count, residuals within 1e-10.  The GS fault word (a
     sync-free wait that gave up) is 0 after every GS phase.
 11. bench.py's 96^3 configuration with the device setup chain
     (device_setup, lattice_coeffs (1, 1, 1): strength, PMIS, classical
     interpolation, RAP of level 0 on the card), f64 and f32/bf16/ngt
     0.02: the chain engaged, the JAX package's counts (DS96_F64,
     DS96_F32), launches exactly as the hierarchy says; the card's CF
     bitwise lattice_pmis_host's, P0 and level-1 A against the same
     chain on the CPU (f64 within 1e-14, f32 4 ulp); the solve's median
     of 10, device busy and kernels an iteration; setup by phase (DS_*)
     and time to a first solution, one round (DS_ROUNDS), in turns
     with the host setup and the plain path.
 12. the cycle options and the coarsening family at 96^3, each through
     the user's entry points with the counts at 0 before and read
     after: W-cycles (f64, f32/bf16/ngt 0.02, and f64 on the lattice
     forms), the F-cycle, additive / mult_additive / simple from level
     0, C / F l1-Jacobi point sweeps (grid_relax_points),
     grid_relax_type (13, 13, 14, 9), HMIS and RS coarsening: the JAX
     package's counts (CYCLES96; f32/bf16 within one), a right
     solution, launches exactly `cycle_launches` x the cycles plus
     PCG's matvecs, with the statistics, the setup by phase, the
     solve's median of 3 and device busy; every operator of the
     lattice W hierarchy held against its plain version; at 24^3 CLJP,
     Falgout, CGC, CR, strength_abs, seq_threshold 150 and SolveT card
     against CPU (the same counts, residuals within 1e-10).
 13. aggressive coarsening, the interpolation family and AIR: at 96^3
     on the plain forms with ext+i and P_max_elmts 4, one aggressive
     level in the multipass form (f64 and f32/bf16/ngt 0.02), the
     two-stage form and MFEM's CPU default (HMIS, relax 8), each as in
     12 (AGG96: the JAX package's counts, launches exactly, statistics,
     setup by phase, median of 3, device busy), every operator of the
     f64 multipass hierarchy held against its plain version; at 24^3
     card against CPU standard, standard-sep, ff, ff1, ext, direct and
     multipass interpolation, post_interp_type 1, num_paths 2 with
     agg_P_max_elmts 4 (INTERP24) and one aggressive level on the
     lattice defaults with the JAX package's gates (AGG_LATTICE24); AIR
     on the convection-diffusion operator through the stationary solve
     (restrict_type 1, 2, 2 with air_neumann_degree 2, and SolveT with
     1; AIR24), every operator of each Solve hierarchy held.
 14. systems / nodal / GSMG BoomerAMG, the Krylov family and LOBPCG: at
     96^3 on the plain forms (SYS96) sys_laplacian_7pt(96, 96, 96, 2)
     with the hypre oracle's nodal protocol (nodal 1, max_row_sum 1.0),
     K1 alone at its 19-offset level 0 (against its plain version,
     timed beside it, cuSPARSE CSR and its DIA- and nonzero-bytes
     bounds) and every operator held; the unknown approach with ext+i;
     the nodal one in f32/bf16; GSMG with ext+i; each as in 12; the
     convection-diffusion hierarchy (ext+i) under GMRES, FlexGMRES,
     LGMRES, COGMRES (CGS 1 and 2) and BiCGSTAB (KRYLOV96: the JAX
     package's counts, the true residual, the operator applications
     each solver's loop predicts and exactly their launches, median of
     20, busy); LOBPCG (m 4, the V-cycle as T) against the closed-form
     eigenvalues.  At 24^3 card against CPU: nodal 1, 2, 3, 4, 6 with
     nodal_diag 0 and 1, a user dof_func, GSMG (SYS24), the offset
     budgets on the lattice defaults with the JAX package's gates
     (BUDGET24), CGNR with the V-cycle and with the diagonal (CGNR24,
     the histories), LOBPCG (LOBPCG24).
 15. the ij driver (hypre_tpu_torch/drivers/ij.py) and what it reaches,
     each run through the driver's `run(argv, device=...)` with the
     counts at 0 before and read after: (a) the oracle line at 96^3
     (IJ96_ORACLE: exactly 25 iterations, the true residual, the
     complexity lines the JAX driver prints, launches exactly as the
     hierarchy says, the lattice forms engaged; median of 3, busy);
     (f) that hierarchy saved (utils/io.py), loaded on the card, solved
     again: the same count and x bitwise; (b) AMG hybrid (-solver 20
     -rlx 18: the JAX package's DS-PCG and AMG-PCG counts, launches
     exactly); (c) ILU(1)-GMRES (-solver 81: the JAX package's count,
     two gs_sweep launches an application, the factor and schedule
     times; gs_sweep on both factors' schedules and one whole
     application held against the plain version); (d) IJ assembly of
     the 96^3 Laplacian on the host and the card from one seeded
     interleaved Set/AddTo stream, both bitwise the operator, and from
     a second stream of inexact AddTo sums over the 48^3 Laplacian's
     nonzeros (IJ_INEXACT_NX), each of two card runs within 1e-12 of
     the host accumulator, whether they repeat bitwise reported; (e) -smtype 6 / 8 / 9 -smlv 2 at 48^3 and (g) every
     other solver id at 24^3, card against CPU.
 16. the AMG family, each line through the solver's own entry points
     with the counts at 0 before and read after, f64, b = ones: (a)
     SA-AMG-PCG at 96^3; (b) PILUT-GMRES(30) at 48^3, gs_sweep on every
     stage's and the tail's schedules and one whole application held
     against the plain versions; (c) MGR-FlexGMRES on the 48^3 two-
     function systems Laplacian, function 1 C, with MGROptions() and
     with block-Jacobi interpolation / restriction, AMG F-relaxation and
     the Galerkin coarse grid; (d) AMS-PCG on the 48^3 curl-curl edge
     problem; (e) ADS-PCG on the 13^3 div-div face problem; (f) AME on
     the 16^3 curl-curl problem; (g) AMG-DD at 24^3 (8 domains, padding
     2): the host solve, the device cycle in f64 (flat_take) and f32
     (take_along_axis) against the host cycle, every gather bitwise its
     plain version, the level-0 gather timed; (h) BlockAMG-PCG at 24^3 x
     2, direct and classical block interpolation.  Each line: the JAX
     package's count (AUX_*), the true residual, setup seconds, solve
     ms, launches exactly as the solver's own counts predict (busy and
     idle for (a), (d), (g)); the frozen operators and auxiliary
     hierarchies held against their plain versions.  Then every solver
     at 4^3-16^3 card against CPU.
 17. the struct interface, each line through the port's struct driver
     (hypre_tpu_torch/drivers/struct.py, f64) with the counts at 0
     before and read after: (a) PFMG at 96^3, (b) PFMG-PCG at 96^3, (c)
     the anisotropic pfmgbase3d shape (-c 2 3 40) at 96^3, (d) SMG and
     SMG-PCG at 48^3 (the recursive 2-D plane solver, PCR line solves),
     (e) SparseMSG at 32^3, its frozen transfers on the ELL kernel (K1
     would carry a square one) exactly as `cycle_launches` says, then
     each transfer held against its plain version (`hold_ops`) and one
     cycle against the CPU's: each the JAX package's count
     (STRUCT_JAX), the true residual, setup by phase (STRUCT_*), the
     solve's median of 3 (one timed solve for (d), (e): STRUCT_REPS), one
     cycle's device busy, idle and kernels, the seconds of each step;
     (f) solver ids 8, 17-19, 25, 30, 31, 38, 39
     at 24^3 card against CPU (the same count, x within 1e-12); (g) the
     [REF] / [REF~] lines of tests/test_regression_drivers.py; (h) the
     multi-box lines (-P / -b): the multi-box matvec against the
     canonical one within 1e-12, then the JAX package's count; (i)
     examples/ex1.py's 32x32 PFMG through the port's API; (j)
     struct_matvec at 96^3 alone, a variable 7-point stencil as built
     (grid slices) and boxed (flat runs), a constant one, beside their
     bytes bounds and kernels a call, and K1 on the same operator as a
     7-offset DIA matrix, held against each other (run after the
     builds, before any profile);
 18. the sstruct interface: the port's `sstruct` driver
     (hypre_tpu_torch/drivers/sstruct.py, f64, b = ones, tol 1e-6) on the
     built-in two-part layout with the counts at 0 before and read after:
     (a) PCG + Split-PFMG, (c) SysPFMG, (d) DS-PCG, each at 96^3 a part
     (1,769,472 unknowns; SysPFMG part 0's block) against the port's CPU
     count there (SSTRUCT96), and at 48^3 against the JAX package's
     (SSTRUCT_JAX); (b) Split-PFMG at 48^3 a part against the JAX
     package's (its 96^3 line made room for phase 19); the true residual, setup by
     phase, the solve's seconds (medians: SSTRUCT_REPS), one iteration's
     busy / idle / kernels, K1 / ELL launches as the code predicts (the U
     part, a 2-offset DIA matrix, is K1's: once a sstruct_matvec, once a
     Split step); (e) ids 8, 13, 19 at 24^3 and 0, 10 at 12^3 card vs
     CPU; (f) every
     SSTRUCT_INFILES text through -in with ids 18, 20, 11 (FAC-AMR 99 on
     the FacParts text), card vs CPU, the largest composite 135,265
     unknowns; (g) SStructMaxwell's three branches (parts at origins and
     rotated parts through the TV multigrid, block-diagonal parts through
     AMS), card vs CPU; (h) FAC on build_composite_amr inside GMRES,
     card vs CPU; (i) (a)'s U alone: K1 against its plain version, timed
     beside cuSPARSE and the DIA-bytes and nonzero-bytes bounds.
 19. the sharded solver (hypre_tpu_torch/parallel/): 4 shards on the
     card(s) (shard s on CUDA device s % count; one card holds them all,
     and a printed line says what that can and cannot show), f64.
     `entry.dryrun_multichip` with the counts at 0 before and read after:
     (a) 48^3 l1-Jacobi ext+i, the fine level a ParDIA, the sharded PCG
     at the serial count and the JAX package's (PAR_JAX); (b) hybrid
     SSOR (relax 6) at 24^3, two sharded levels, the JAX package's
     count; (c) the general-CSR setup chain at 12^3, CF and P bitwise at
     both transitions.  Then (a)'s and (b)'s sharded PCG again, each
     with the counts at 0 before and read after (the kernels line's
     `par` launches): launches exactly as `ParAMG.cycle_launches` and
     the fine products predict, their median of 3 (CUDA events), busy /
     idle and kernels an iteration, the unsharded solve on the same card
     beside them; K1, the ELL kernel and gs_sweep each on one shard's
     operator against its plain version, timed beside its bound and
     cuSPARSE (K1 also beside the bound of the shard product's kept
     rows, which its extended operator exceeds);
     dist_lattice_setup at 48^3 bitwise the serial device chain;
     IJMatrixSharded at 48^3 equal to from_row_blocks.
 20. the sharded struct stack (hypre_tpu_torch/parallel/par_struct.py:
     layouts, the ghost-plane exchange, `shard_solver`) and
     AMG-DD's sharded domains, 4 shards on the card(s) as in 19, f64,
     b = ones, each sharded run with the counts at 0 before and read
     after: (a) PFMG 96^3 cut along axis 0, (b) PFMG -c 2 3 40 96^3 on a
     2 x 2 process grid, (c) PFMG-PCG 96^3 ((a)'s PFMG), each at the JAX
     package's serial count (STRUCT_JAX) and the serial port's on the
     card, x against the serial x (bitwise or 1e-12; (c)'s history
     within 1e-12), no counted launch, each solve timed once and warm
     beside the serial one, one cycle of each profiled ((a), (b)); (d) the [REF]
     pfmgbase3d / smgbase3d lines at 12^3 cut along axis 0 (SMG's planes
     cut: gathered whole) and axis 2 (SMG's planes whole, coarse shards
     empty); (e) SparseMSG 16^3, every transfer a ParCSR: ELL launches
     exactly 4 x the transfers x the cycles; (f) struct Jacobi and
     hybrid 24^3 against the serial card run; (g) AMGDDDevice 24^3, 8
     domains on 4 shards, f64 and f32, the sharded cycle against the
     unsharded one, K2 launches a shard as `shard_launches` predicts,
     the stationary solve with it at AUX_DD24, PCG with it at 10^3 at the
     unsharded count.  The counted runs of (e) and (g) are the kernels
     line's `par_struct` launches.
The last three lines are the slice's numbers (entry, device RAP, ext+i,
the GS family, the device setup chain, the cycle options, aggressive
coarsening and AIR, the systems phase, the ij phase, the AMG family,
the struct phase, the sstruct phase, the sharded phase, the sharded
struct phase), the kernel report and {"ok": true, ...}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch

from hypre_tpu_torch.profile_slice import DS_PHASES
from hypre_tpu_torch.utils.timing import REPS, time_cuda_ms

NX = 96
ORACLE_F64 = 25  # hypre 2.20 `ij -laplacian` at 96^3 (BASELINE.md)
PRODUCTION_F32 = 21  # the JAX package's count for the f32/bf16 config
# H100 SXM data sheet: HBM3 bandwidth, and the non-tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_options(interp_type="classical", **kw):
    """The bench protocol's options on the plain forms; `kw` adds to or
    overrides them (relax_down / relax_up among them)."""
    from hypre_tpu_torch.solvers.amg import BoomerAMGOptions

    return BoomerAMGOptions(**{
        **dict(coarsen_type="pmis", interp_type=interp_type, P_max_elmts=4,
               relax_down=18, relax_up=18, embed_level1=False,
               relocate_level2=False, collapse_coarse_n=0), **kw})


def lattice_options(nx: int, interp_type="classical", **kw):
    """The JAX package's own option defaults (embed_level1 with the
    level-1 values from the device RAP, relocate_level2, relocate_tail,
    collapse_coarse_n=2048) on the nx^3 lattice: the production pin's
    options (tests/test_oracle_parity.py:70-84)."""
    from hypre_tpu_torch.solvers.amg import BoomerAMGOptions

    return BoomerAMGOptions(
        coarsen_type="pmis", interp_type=interp_type, P_max_elmts=4,
        relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx), **kw)


def make_solve(amg):
    """The bench protocol's solve over a hierarchy: PCG, two-norm test,
    tol 1e-6, b = ones."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    b = torch.ones_like(amg.levels[0].dinv)
    A0 = amg.levels[0].A
    return lambda: pcg(lambda x: spmv(A0, x), b, M=amg.precond,
                       opts=PCGOptions(tol=1e-6, max_iter=200, two_norm=True))


def run_slice(nx: int, opts, device, A=None):
    """Setup + freeze + PCG on the nx^3 Poisson problem (or on the matrix
    A), as a user calls it.  Returns (amg, result, setup_s, solve_s); on
    the card the solve is timed with CUDA events, setup with the host
    clock."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    dev = torch.device(device)
    t0 = time.perf_counter()
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx) if A is None else A, opts,
                    device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    solve = make_solve(amg)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        res = solve()
        return amg, res, setup_s, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = solve()
    end.record()
    end.synchronize()
    return amg, res, setup_s, start.elapsed_time(end) / 1e3


def ell_operators(amg):
    """[(label, ELLMatrix, launches per V-cycle)] of a hierarchy.  Per
    cycle with one sweep down and up and the u_zero skip: A twice on
    every ELL level above the coarsest (residual, up-smooth), P and R
    once each."""
    from hypre_tpu_torch.ops import ELLMatrix

    ops = []
    for l, lvl in enumerate(amg.levels[:-1]):
        for name, M, k in (("A", lvl.A, 2), ("P", lvl.P, 1), ("R", lvl.R, 1)):
            if isinstance(M, ELLMatrix):
                ops.append((f"L{l} {name}", M, k))
    return ops


def check_solution(amg, res, n):
    """Finite x of the right shape whose true residual ||b - A x|| /
    ||b||, computed in float64 with K1's plain version (no kernel),
    meets the solve's tolerance up to what x's own precision allows:
    tol + 4 eps ||A||_inf ||x|| / ||b||, eps of the solve's dtype (in
    float32 that term is ~1e-4 at 96^3, in float64 negligible)."""
    require(res.x.shape == (n,), f"solution shape {tuple(res.x.shape)}")
    rel, bound = true_residual(amg.levels[0].A, res.x, 1e-6)
    require(rel < bound, f"true relative residual {rel:.3e} above {bound:.3e}")
    return rel, bound


def csr_from_ell(A, dtype):
    """The ELL operator as a torch CSR tensor (cuSPARSE's SpMV, the
    library yardstick), padding dropped, values in `dtype`."""
    data = A.data.t().to(dtype)
    keep = data != 0
    crow = torch.zeros(A.num_rows + 1, dtype=torch.int64, device=data.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    with warnings.catch_warnings():  # torch's "sparse CSR is beta" notice
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, A.cols.t()[keep].long(), data[keep],
            size=(A.num_rows, A.num_cols), check_invariants=False)


def k1_cases(dev):
    """(label, data, offsets tuple, x, tol) on the card."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia import csr_to_dia

    rng = np.random.default_rng(2024)
    A = laplacian_7pt(NX, NX, NX)
    n = NX**3
    xs = rng.standard_normal(n)
    cases = []
    for label, ddt, xdt, tol in (("96^3 f64", "float64", torch.float64, 1e-12),
                                 ("96^3 f32", "float32", torch.float32, 1e-5),
                                 ("96^3 bf16 data, f32 x", "bfloat16",
                                  torch.float32, 1e-5)):
        D = csr_to_dia(A, ddt, dev)
        cases.append((label, D.data, D.offsets,
                      torch.from_numpy(xs).to(dev, xdt), tol))
    for offs in ((-320, -1, 0, 1, 320), (0, 3, 7, 100)):
        n2 = 20000
        data = rng.standard_normal((len(offs), n2)).astype(np.float32)
        x2 = rng.standard_normal(n2).astype(np.float32)
        cases.append((f"n={n2} offsets {offs}", torch.from_numpy(data).to(dev),
                      offs, torch.from_numpy(x2).to(dev), 1e-5))
    # wide union, out-of-range taps left nonzero in data: only the
    # kernel's bounds check keeps them out
    n3 = 4096
    offs3 = tuple(int(o) for o in np.unique(rng.integers(-400, 400, 130)))
    data3 = rng.standard_normal((len(offs3), n3)).astype(np.float32)
    x3 = rng.standard_normal(n3).astype(np.float32)
    cases.append((f"n={n3} {len(offs3)} random offsets",
                  torch.from_numpy(data3).to(dev), offs3,
                  torch.from_numpy(x3).to(dev), 1e-5))
    return cases


def phase_k1(dev, flush, card):
    """K1 against its plain version; times at 96^3.  Returns
    {label: (ms, plain_ms, library_ms, max_abs_err, bound_ms, bound_by)}."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference

    A_ell = laplacian_7pt(NX, NX, NX).to_ell("float64", dev)
    out = {}
    for label, data, offs, x, tol in k1_cases(dev):
        y = dia_spmv_cuda(data, offs, x)
        y_ref = dia_spmv_reference(data, offs, x)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        log(f"K1 vs plain [{label}]: max abs err {err:.3e}, "
            f"rel {rel:.3e} (tol {tol:g})")
        require(rel <= tol, f"K1 disagrees with its plain version on {label}")
        if not label.startswith("96^3"):
            continue
        n = x.shape[0]
        nbytes = (len(offs) * data.element_size() + 2 * x.element_size()) * n
        bms, by = bound_ms(nbytes, 2 * len(offs) * n, x.dtype)
        # cuSPARSE has no bf16 x f32 product: f32 values stand in
        lib_dt = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
        csr = csr_from_ell(A_ell, lib_dt)
        x_lib = x.to(lib_dt)
        ms = time_cuda_ms(lambda: dia_spmv_cuda(data, offs, x), flush)
        plain_ms = time_cuda_ms(lambda: dia_spmv_reference(data, offs, x), flush)
        lib_ms = time_cuda_ms(lambda: csr @ x_lib, flush)
        out[label] = (ms, plain_ms, lib_ms, err, bms, by)
        log(f"  time [{label}; {card}], L2 flushed, median of {REPS}: "
            f"K1 {ms * 1e3:.1f} us ({nbytes / ms / 1e6:.0f} GB/s), "
            f"plain {plain_ms * 1e3:.1f} us, cuSPARSE CSR ({lib_dt}) "
            f"{lib_ms * 1e3:.1f} us; {nbytes / 1e6:.1f} MB, floor "
            f"{bms * 1e3:.1f} us")
    return out


JACOBI_W = 0.7


def form_operands(form, n, dtype, dev, rng):
    """The form's seeded vectors of n entries (d > 0, as D^{-1} is)."""
    from hypre_tpu_torch.ops.forms import OPERANDS

    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    ops = {"f": t(rng.standard_normal(n)), "u": t(rng.standard_normal(n)),
           "d": t(rng.uniform(0.1, 1.0, n))}
    ops = {k: v for k, v in ops.items() if k in OPERANDS[form]}
    if form == "jacobi":
        ops["w"] = JACOBI_W
    return ops


def check_form(name, label, form, fused, plain, tol):
    """Hold one fused launch against its plain version; returns the max
    abs error."""
    y, y_ref = fused(), plain()
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    rel = err / max(float(y_ref.abs().max()), 1e-300)
    require(rel <= tol, f"{name} {form} disagrees with its plain version on "
                        f"{label}: rel {rel:.3e} (tol {tol:g})")
    return err, rel


def phase_k1_forms(dev, flush, card):
    """K1's fused forms at 96^3 against their plain versions, each timed
    beside the unfused sequence (K1 plain, then torch's elementwise ops,
    as the V-cycle ran them before).  Returns {label: {form: (ms,
    unfused_ms, bound_ms, bound_by, max_abs_err)}}."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
    from hypre_tpu_torch.ops.forms import OPERANDS, epilogue

    rng = np.random.default_rng(5)
    out = {}
    for label, data, offs, x, tol in k1_cases(dev):
        if not label.startswith("96^3"):
            continue
        n, vsz = x.shape[0], x.element_size()
        out[label] = {}
        for form in ("resid", "axpy", "jacobi"):
            ops = form_operands(form, n, x.dtype, dev, rng)
            fused = lambda: dia_spmv_cuda(data, offs, x, form, **ops)  # noqa: E731
            err, rel = check_form("K1", label, form, fused, lambda: (
                dia_spmv_reference(data, offs, x, form, **ops)), tol)
            unfused = lambda: epilogue(  # noqa: E731
                form, dia_spmv_cuda(data, offs, x), x, **ops)
            nbytes = (len(offs) * data.element_size()
                      + vsz * (2 + len(OPERANDS[form]))) * n
            bms, by = bound_ms(nbytes, (2 * len(offs) + 4) * n, x.dtype)
            ms = time_cuda_ms(fused, flush)
            un_ms = time_cuda_ms(unfused, flush)
            out[label][form] = (ms, un_ms, bms, by, err)
            log(f"K1 {form} [{label}; {card}]: rel err {rel:.2e}; fused "
                f"{ms * 1e3:.1f} us, unfused (K1 + torch elementwise) "
                f"{un_ms * 1e3:.1f} us; floor {bms * 1e3:.1f} us "
                f"({nbytes / 1e6:.1f} MB)")
    return out


def gather_ptxas(out: str) -> list[tuple[str, int, int]]:
    """[(kernel instance, registers, spill bytes)] of csrc/gather.cu from
    its build's ptxas report (empty when the library was current)."""
    rows = []
    for block in out.split("Compiling entry function")[1:]:
        mangled = re.match(r"\s*'(\S+)'", block).group(1)
        name = re.search(r"(take_along_axis|flat_take)\w*?_kernel", mangled)
        args = re.search(r"_kernelI(.*?)E+v", mangled)
        tmpl = args.group(1) if args else ""
        take = re.fullmatch(r"Li(\d)ELb(\d)ELi(\d+)", tmpl)
        if take:
            tmpl = (f"{take.group(1)}, {('l2', 'shared')[int(take.group(2))]}, "
                    f"{take.group(3)}")
        else:
            tmpl = {"f": "float", "d": "double"}.get(tmpl, tmpl)
        regs = re.search(r"Used (\d+) registers", block)
        rows.append((f"{name.group(0) if name else mangled}<{tmpl}>",
                     int(regs.group(1)) if regs else -1,
                     sum(int(b) for b in re.findall(r"(\d+) bytes spill", block))))
    return rows


def time_in_turns(new, old, flush, floor=None):
    """(new form's ms, earlier form's ms, empty kernel's ms or None): each
    the mean of two medians of time_cuda_ms, taken in turns new, old,
    [empty kernel,] old, new in one call."""
    t = [time_cuda_ms(new, flush), time_cuda_ms(old, flush)]
    f = time_cuda_ms(floor, flush) if floor is not None else None
    t += [time_cuda_ms(old, flush), time_cuda_ms(new, flush)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, f


def phase_gathers(dev, flush, card, build_log):
    """The TPU gather probes' four gathers (scripts/exp_mosaic_gather.py
    K2 (a) :35, (b) :43, (c) :52; K3 :65) at their shapes, through the
    kernels' default (tiled) form, counted, then both forms held bitwise
    against the plain versions there and on a ragged and a too-wide
    (L2-instance) shape for each axis, and each probe timed: the tiled
    form and the elementwise form in turns, the empty kernel, the bytes
    bound, the plain version and the library call.  Returns ({kernel:
    launches}, {probe: {ms, earlier_ms, floor_ms, plain_ms, library_ms,
    bound_ms, bound_by, max_abs_err}})."""
    from hypre_tpu_torch.lane_sweep import time_clean_l2_ms
    from hypre_tpu_torch.ops.gather_kernel import (
        flat_take_cuda, flat_take_reference, take_along_axis_cuda,
        take_along_axis_reference, take_plan)

    rows = gather_ptxas(build_log)
    new = [r for r in rows if "elementwise" not in r[0]]
    for name, regs, spill in rows:
        log(f"gather.cu ptxas: {name}: {regs} registers, {spill} bytes spilled")
    if rows:
        require(len(new) == 10 and all(sp == 0 for _, _, sp in new),
                f"gather.cu: the tiled instances {new} spill or are missing")
    else:
        log("gather.cu was current (not built in this run): no ptxas report")

    rng = np.random.default_rng(0)
    g = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    x2 = g(rng.standard_normal((64, 512)).astype(np.float32))
    iL = g(rng.integers(0, 512, size=(64, 512)).astype(np.int32))
    iS = g(rng.integers(0, 64, size=(64, 512)).astype(np.int32))
    xf = g(rng.standard_normal(128 * 1024).astype(np.float32))
    iF = g(rng.integers(0, xf.numel(), size=(64, 512)).astype(np.int32))
    S, L, G = 512, 512, 8
    xb = g(rng.standard_normal((S, L)).astype(np.float32))
    ib = g(rng.integers(0, L, size=(G * S, L)).astype(np.int32))
    taa = (("K2 (a) lanes", x2, iL, 1), ("K2 (b) sublanes", x2, iS, 0),
           ("K3 grid", xb, ib, 1))

    take_along_axis_cuda.launches = flat_take_cuda.launches = 0
    outs = [take_along_axis_cuda(x, i, axis) for _, x, i, axis in taa]
    out_c = flat_take_cuda(xf, iF)
    torch.cuda.synchronize()
    launches = {"take_along_axis": take_along_axis_cuda.launches,
                "flat_take": flat_take_cuda.launches}
    log(f"gathers: launches {launches}")
    require(launches == {"take_along_axis": 3, "flat_take": 1},
            "the gather probes did not all go through the kernels")
    errs = {}
    for (label, x, i, axis), out in zip(taa, outs):
        ref = take_along_axis_reference(x, i, axis)
        errs[label] = float((out - ref).abs().max())
        require(torch.equal(out, ref),
                f"take_along_axis differs from its plain version on {label}")
    ref = flat_take_reference(xf, iF)
    errs["K2 (c) flat"] = float((out_c - ref).abs().max())
    require(torch.equal(out_c, ref), "flat_take differs from its plain version")

    # both forms, bitwise, on the probes' shapes and on ragged and too-wide
    # shapes.  Each call gets inputs of its own and a NaN-filled block of
    # its output's size freed just before it, so no block the allocator
    # hands the kernel can hold its answer from an earlier call: an
    # element the kernel leaves unwritten shows
    def poison(n, dt):
        torch.full((n,), float("nan"), dtype=dt, device=dev)

    held = [(label, tuple(x.shape), tuple(i.shape), axis)
            for label, x, i, axis in taa]
    held += [("ragged axis 1", (8, 37), (24, 513), 1),
             ("ragged axis 0", (7, 33), (5, 99), 0),
             ("wide axis 1", (1, 60_000), (3, 60_000), 1),
             ("wide axis 0", (2000, 40), (10, 80), 0)]
    for label, xs, ish, axis in held:
        for form in ("tiled", "elementwise"):
            x = g(rng.standard_normal(xs).astype(np.float32))
            i = g(rng.integers(0, xs[1] if axis == 1 else xs[0],
                               size=ish).astype(np.int32))
            poison(i.numel(), x.dtype)
            out = take_along_axis_cuda(x, i, axis, form=form)
            require(torch.equal(out, take_along_axis_reference(x, i, axis)),
                    f"take_along_axis ({form}) differs from its plain "
                    f"version on {label}")
        plan = take_plan(xs, ish, axis)
        log(f"take_along_axis vs plain [{label}, x {xs}, idx {ish}, axis "
            f"{axis}; {plan.instance} instance, grid {plan.grid}, "
            f"{plan.smem} B shared]: both forms bitwise equal")
    for n, dt in ((32_768, torch.float32), (1_003, torch.float64),
                  (1_003, torch.float32)):
        for form in ("tiled", "elementwise"):
            tbl = g(rng.standard_normal(131_072)).to(dt)
            i = g(rng.integers(0, 131_072, size=n).astype(np.int32))
            poison(n, dt)
            out = flat_take_cuda(tbl, i, form=form)
            require(torch.equal(out, flat_take_reference(tbl, i)),
                    f"flat_take ({form}) differs from its plain version on "
                    f"{n} {dt}")
    log("flat_take vs plain [K2 (c), table 131072, idx (64, 512); 1,003 "
        "ragged, f64 and f32]: both forms bitwise equal")

    def taa_library(x, i, axis):
        il = i.long()  # take_along_dim takes int64 only; cast outside the timing
        if x.shape == i.shape:
            return lambda: torch.take_along_dim(x, il, dim=axis)
        return lambda: torch.take_along_dim(x.unsqueeze(0), il.view(G, S, L),
                                            dim=2)

    cases = []
    for label, x, i, axis in taa:
        cases.append((label, x.numel(),
                      lambda x=x, i=i, a=axis: take_along_axis_cuda(x, i, a),
                      lambda x=x, i=i, a=axis: take_along_axis_cuda(
                          x, i, a, form="elementwise"),
                      lambda x=x, i=i, a=axis: take_along_axis_reference(x, i, a),
                      "take_along_dim", taa_library(x, i, axis), i.numel()))
    iF_flat = iF.view(-1)
    cases.append(("K2 (c) flat", xf.numel(), lambda: flat_take_cuda(xf, iF),
                  lambda: flat_take_cuda(xf, iF, form="elementwise"),
                  lambda: flat_take_reference(xf, iF), "index_select",
                  lambda: torch.index_select(xf, 0, iF_flat), iF.numel()))
    times = {}
    for label, tbl, fn, old, plain, lib_name, lib, ne in cases:
        nbytes = 4 * (2 * ne + tbl)  # idx in, out back, the table once
        bms, by = bound_ms(nbytes, 0, torch.float32)
        ms, earlier_ms, floor_ms = time_in_turns(
            fn, old, flush, lambda: torch.cuda._sleep(0))
        plain_ms, lib_ms = (time_cuda_ms(f, flush) for f in (plain, lib))
        times[label] = {"ms": ms, "earlier_ms": earlier_ms,
                        "floor_ms": floor_ms, "plain_ms": plain_ms,
                        "library_ms": lib_ms, "bound_ms": bms,
                        "bound_by": by, "max_abs_err": errs[label]}
        log(f"  time [{label}, {ne} gathers; {card}], L2 flushed, medians of "
            f"{REPS}, in turns: tiled {ms * 1e3:.2f} us = "
            f"{ms * 1e6 / ne:.4f} ns/elem, elementwise (earlier) "
            f"{earlier_ms * 1e3:.2f} us, empty kernel {floor_ms * 1e3:.2f} us; "
            f"plain {plain_ms * 1e3:.2f} us, torch {lib_name} "
            f"{lib_ms * 1e3:.2f} us; bound {bms * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
        if label == "K3 grid":
            # the same after a flush that reads (clean L2 lines): what the
            # write-back of the usual flush's dirty lines adds to K3
            clean = [time_clean_l2_ms(f, flush) for f in (fn, old)]
            times[label]["clean_l2"] = {"ms": clean[0], "earlier_ms": clean[1]}
            log(f"  time [K3 grid; {card}], L2 flushed by a read (clean "
                f"lines): tiled {clean[0] * 1e3:.2f} us, elementwise "
                f"{clean[1] * 1e3:.2f} us")
    return launches, times


def phase_ell(amg, tol, flush, card, label):
    """The ELL kernel against its plain version on every ELL operator of
    a hierarchy, each timed with the L2 flushed beside its floors and
    the cuSPARSE CSR product; then every form on every operator against
    its plain version, and the forms the V-cycle uses (A: resid and
    jacobi, P: axpy) timed beside the unfused sequence.  Returns
    per-V-cycle sums of the plain form (ms, plain_ms, library_ms,
    bound_ms, bound_by), the largest abs error, and the forms' sums
    {form: (ms, unfused_ms, bound_ms, bound_by, max_abs_err)}, with
    "v_cycle" the cycle's matvecs in the forms the path runs."""
    from hypre_tpu_torch.ops.ell_kernel import (
        ell_spmv_cuda, ell_spmv_reference, slot_lanes)
    from hypre_tpu_torch.ops.forms import OPERANDS, epilogue

    rng = np.random.default_rng(11)
    worst = 0.0
    tot = np.zeros(4)
    forms = {f: np.zeros(4) for f in ("resid", "axpy", "jacobi", "v_cycle")}
    vdt = amg.levels[0].dinv.dtype
    for name, A, per_cycle in ell_operators(amg):
        x = torch.from_numpy(rng.standard_normal(A.num_cols)).to(
            A.data.device, vdt)
        y = ell_spmv_cuda(A.data, A.cols, A.row_len, x)
        y_ref = ell_spmv_reference(A.data, A.cols, x)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        require(rel <= tol, f"ELL kernel disagrees with its plain version "
                            f"on {label} {name}: rel {rel:.3e}")
        worst = max(worst, err)
        width, n = A.data.shape
        vsz, msz = x.element_size(), A.data.element_size()
        pad_bytes = width * n * (msz + 4) + vsz * (n + A.num_cols)
        # nnz entries, row_len, x and y once
        nnz_bytes = A.nnz * (msz + 4) + 4 * n + vsz * (n + A.num_cols)
        bms, by = bound_ms(nnz_bytes, 2 * A.nnz, vdt)
        csr = csr_from_ell(A, vdt)
        ms = time_cuda_ms(lambda: ell_spmv_cuda(A.data, A.cols, A.row_len, x),
                       flush)
        plain_ms = time_cuda_ms(lambda: ell_spmv_reference(A.data, A.cols, x),
                             flush)
        lib_ms = time_cuda_ms(lambda: csr @ x, flush)
        tot += per_cycle * np.array([ms, plain_ms, lib_ms, bms])
        log(f"ELL [{label} {name}, {n}x{A.num_cols}, width {width}, nnz "
            f"{A.nnz}, {slot_lanes(width, n)} lanes, {per_cycle}/cycle; "
            f"{card}]: rel err {rel:.2e}; kernel {ms * 1e3:.1f} us "
            f"({nnz_bytes / ms / 1e6:.0f} GB/s of nnz bytes), plain "
            f"{plain_ms * 1e3:.1f} us, cuSPARSE CSR {lib_ms * 1e3:.1f} us; "
            f"floor {pad_bytes / HBM_BYTES_PER_S * 1e6:.1f} us padded "
            f"({pad_bytes / 1e6:.1f} MB), {bms * 1e3:.1f} us nnz "
            f"({nnz_bytes / 1e6:.2f} MB)")
        # the forms: all against the plain version, the path's timed
        kind = name.split()[-1]
        path_forms = {"A": ("resid", "jacobi"), "P": ("axpy",), "R": ()}[kind]
        if kind == "R":
            forms["v_cycle"] += np.array([ms, ms, bms, 0.0])
        for form in ("resid", "axpy", "jacobi"):
            if form == "jacobi" and n != A.num_cols:
                continue
            ops = form_operands(form, n, vdt, x.device, rng)
            fused = lambda: ell_spmv_cuda(  # noqa: E731
                A.data, A.cols, A.row_len, x, form, **ops)
            ferr, frel = check_form("ELL", f"{label} {name}", form, fused,
                                    lambda: ell_spmv_reference(
                                        A.data, A.cols, x, form, **ops), tol)
            worst = max(worst, ferr)
            if form not in path_forms:
                log(f"ELL {form} [{label} {name}]: rel err {frel:.2e}")
                continue
            unfused = lambda: epilogue(  # noqa: E731
                form, ell_spmv_cuda(A.data, A.cols, A.row_len, x), x, **ops)
            fbytes = nnz_bytes + vsz * n * len(OPERANDS[form])
            fbms, _ = bound_ms(fbytes, 2 * A.nnz + 4 * n, vdt)
            fms = time_cuda_ms(fused, flush)
            un_ms = time_cuda_ms(unfused, flush)
            forms[form][:3] += [fms, un_ms, fbms]
            forms[form][3] = max(forms[form][3], ferr)
            forms["v_cycle"] += np.array([fms, un_ms, fbms, 0.0])
            log(f"ELL {form} [{label} {name}; {card}]: rel err {frel:.2e}; "
                f"fused {fms * 1e3:.1f} us, unfused (kernel + torch "
                f"elementwise) {un_ms * 1e3:.1f} us; floor {fbms * 1e3:.1f} us")
    forms["v_cycle"][3] = worst
    log(f"ELL [{label}] per V-cycle ({card}), plain form: kernel "
        f"{tot[0] * 1e3:.1f} us, plain {tot[1] * 1e3:.1f} us, cuSPARSE "
        f"{tot[2] * 1e3:.1f} us, floor (nnz bytes) {tot[3] * 1e3:.1f} us")
    for form, (fms, un_ms, fbms, _) in forms.items():
        log(f"ELL [{label}] per V-cycle ({card}), {form}: fused "
            f"{fms * 1e3:.1f} us, unfused {un_ms * 1e3:.1f} us, floor "
            f"{fbms * 1e3:.1f} us")
    form_out = {f: (*v[:3], "bytes", float(v[3])) for f, v in forms.items()}
    return (*tot, "bytes"), worst, form_out


def cycle_operators(amg):
    """[(label, operator, rows in, rows out, applications per V-cycle)]
    of a frozen hierarchy.  Per cycle with one sweep down and up and the
    u_zero skip: A twice on every level above the last (residual,
    up-smooth), P and R once each, and the last level's coarse solve
    once where it is an operator (the collapsed sub-cycle)."""
    size = [lvl.dinv.shape[0] for lvl in amg.levels]
    ops = []
    for l, lvl in enumerate(amg.levels[:-1]):
        ops += [(f"L{l} A", lvl.A, size[l], size[l], 2),
                (f"L{l} P", lvl.P, size[l + 1], size[l], 1),
                (f"L{l} R", lvl.R, size[l], size[l + 1], 1)]
    ci = amg.levels[-1].coarse_inv
    if not isinstance(ci, torch.Tensor):
        ops.append((f"L{len(size) - 1} coarse solve", ci, size[-1], size[-1], 1))
    return ops


def expected_launches(amg, iterations: int, two_norm: bool = True) -> dict:
    """Kernel launches of one PCG solve over this hierarchy, from the
    operators' formats and the smoothers alone (`BoomerAMG.cycle_launches`):
    iterations + 1 V-cycles (one more without the two-norm test: PCG's
    M(b)) and iterations + 1 fine-level matvecs of PCG's own (K1)."""
    per_cycle = {name: 0 for name in read_counts()}
    for name, c in amg.cycle_launches().items():
        per_cycle[name] += c
    cycles = iterations + (1 if two_norm else 2)
    out = {name: c * cycles for name, c in per_cycle.items()}
    out["dia_spmv"] += iterations + 1  # PCG's matvecs, the fine DIA operator
    return out


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def describe(A):
    """(format, DIA offsets, tail entries, stored entries, stored bytes,
    gathered rows or None) of an operator."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.csr import ELLMatrix

    if isinstance(A, D.DIAMatrix):
        return "DIA", len(A.offsets), 0, A.data.numel(), tensor_bytes(A.data), None
    if isinstance(A, ELLMatrix):
        return ("ELL", 0, 0, A.nnz,
                tensor_bytes(A.data, A.cols, A.row_len), None)
    if isinstance(A, D.DenseMatrix):
        return "dense", 0, 0, A.data.numel(), tensor_bytes(A.data), None
    if isinstance(A, D.DIAWithTail):
        _, noff, _, ne, nb, _ = describe(A.dia)
        t = A.tail
        return ("DIA+tail", noff, t.nnz, ne + t.nnz,
                nb + tensor_bytes(t.vals, t.cols, t.seg_ptr, t.rows_u), None)
    if isinstance(A, (D.GatherOp, D.ScatterOp)):
        fmt, noff, nt, ne, nb, g = describe(A.inner)
        word = "gather" if isinstance(A, D.GatherOp) else "scatter"
        if getattr(A, "row_of_cell", None) is not None:
            word = "on_cells"
            nb += tensor_bytes(A.row_of_cell)
        if isinstance(A, D.GatherOp):
            g = A.pos.numel()
        return f"{word}({fmt})", noff, nt, ne, nb + tensor_bytes(A.pos), g
    if isinstance(A, (D.ParityRestrictOp, D.ParityInterpOp)):
        word = "restrict" if isinstance(A, D.ParityRestrictOp) else "interp"
        ne = sum(m.data.numel() for m in A.mats)
        nb = tensor_bytes(*(m.data for m in A.mats))
        nt = 0
        if A.tail is not None:
            t = A.tail
            nt = t.nnz
            nb += tensor_bytes(t.vals, t.cols, t.seg_ptr, t.rows_u)
        live = sum(1 for m in A.mats if m.offsets)
        return (f"parity {word} x{live}", sum(len(m.offsets) for m in A.mats),
                nt, ne + nt, nb, None)
    raise TypeError(f"describe: unexpected operator {type(A).__name__}")


def plain_spmv(A, x):
    """A x through the kernels' plain torch versions alone (no launch of
    a hand-written kernel), on x's device: what the lattice operators
    are held against."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.csr import ELLMatrix
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_reference
    from hypre_tpu_torch.ops.ell_kernel import ell_spmv_reference
    from hypre_tpu_torch.ops.gather_kernel import flat_take_reference
    from hypre_tpu_torch.ops.tail_kernel import coo_tail_reference

    def tail(t, v, y):
        if t is None:
            return y
        return coo_tail_reference(t.vals, t.cols, t.seg_ptr, t.rows_u, v, y)

    if isinstance(A, D.DIAMatrix):
        return dia_spmv_reference(A.data, A.offsets, x)
    if isinstance(A, ELLMatrix):
        return ell_spmv_reference(A.data, A.cols, x)
    if isinstance(A, D.DenseMatrix):
        return D.dense_spmv(A, x)
    if isinstance(A, D.DIAWithTail):
        return tail(A.tail, x, plain_spmv(A.dia, x))
    if isinstance(A, D.GatherOp):
        return plain_spmv(A.inner, flat_take_reference(x, A.pos))
    if isinstance(A, D.ScatterOp):
        y = plain_spmv(A.inner, x)
        out = torch.zeros(A.n_out, dtype=y.dtype, device=y.device)
        out[A.pos] = y
        return out
    if isinstance(A, D.ParityRestrictOp):
        X = D.parity_split(x, A.fine_shape, A.factors)
        acc = torch.zeros(A.num_rows, dtype=x.dtype, device=x.device)
        for b, m in enumerate(A.mats):
            acc = acc + plain_spmv(m, X[b].contiguous())
        return tail(A.tail, x, acc)
    if isinstance(A, D.ParityInterpOp):
        Y = torch.stack([plain_spmv(m, x) for m in A.mats])
        return tail(A.tail, x, D.parity_merge(Y, A.fine_shape, A.factors))
    raise TypeError(f"plain_spmv: unexpected operator {type(A).__name__}")


def operator_coo(A):
    """(rows, cols, values) of an operator's stored nonzeros, int64 on
    its device: DIA taps inside [0, n), tails, dense entries, positions
    of gathers / scatters, parity parts on the fine lattice."""
    from hypre_tpu_torch.ops import dia as D

    if isinstance(A, D.DIAMatrix):
        k, i = torch.nonzero(A.data, as_tuple=True)
        j = i + torch.tensor(A.offsets, dtype=torch.int64,
                             device=A.data.device)[k]
        keep = (j >= 0) & (j < A.num_cols)
        return i[keep], j[keep], A.data[k[keep], i[keep]]
    if isinstance(A, D.DenseMatrix):
        r, c = torch.nonzero(A.data, as_tuple=True)
        return r, c, A.data[r, c]
    if isinstance(A, D.GatherOp):
        r, c, v = operator_coo(A.inner)
        return r, A.pos.long()[c], v
    if isinstance(A, D.ScatterOp):
        r, c, v = operator_coo(A.inner)
        return A.pos.long()[r], c, v
    parts = []
    if isinstance(A, D.DIAWithTail):
        parts.append(operator_coo(A.dia))
    elif isinstance(A, (D.ParityRestrictOp, D.ParityInterpOp)):
        nfine = int(np.prod(A.fine_shape))
        dev = A.mats[0].data.device
        fine = D.parity_split(torch.arange(nfine, device=dev), A.fine_shape,
                              A.factors)  # [B, ncells]: the fine index
        for b, m in enumerate(A.mats):
            r, c, v = operator_coo(m)
            parts.append((r, fine[b][c], v)
                         if isinstance(A, D.ParityRestrictOp)
                         else (fine[b][r], c, v))
    else:
        raise TypeError(f"operator_coo: unexpected {type(A).__name__}")
    t = A.tail
    if t is not None:
        parts.append((t.rows_u.long()[t.seg.long()], t.cols.long(), t.vals))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(3))


def operator_csr(A, n_in, n_out, dtype):
    """The operator as one torch CSR tensor (cuSPARSE's SpMV, the library
    yardstick) with values in `dtype`: a parity transfer is one
    rectangular CSR."""
    r, c, v = operator_coo(A)
    with warnings.catch_warnings():  # torch's "sparse CSR is beta" notice
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([r, c]), v.to(dtype),
                                      size=(n_out, n_in)).coalesce()
        return coo.to_sparse_csr()


PLAIN_REPS = 10  # a plain lattice matvec is hundreds of torch calls


def phase_lattice_ops(amg, tol, flush, card, label):
    """Every operator of a lattice hierarchy through the kernels (`spmv`)
    against its plain evaluation, timed with the L2 flushed beside its
    bound: stored bytes, the input rows it reads and the output rows it
    writes once, two operations a stored entry, and one cuSPARSE CSR
    product of its nonzeros (f32 values for bf16 storage).  Returns the
    rows [{operator, format, offsets, tail_entries, bytes, per_cycle,
    ms, plain_ms, library_ms, bound_ms, rel_err}]."""
    from hypre_tpu_torch.ops import spmv

    rng = np.random.default_rng(17)
    vdt = amg.levels[0].dinv.dtype
    vsz = torch.empty((), dtype=vdt).element_size()
    dev = amg.levels[0].dinv.device
    rows = []
    for name, A, n_in, n_out, k in cycle_operators(amg):
        fmt, noff, ntail, entries, nbytes, gathered = describe(A)
        x = torch.from_numpy(rng.standard_normal(n_in)).to(dev, vdt)
        y, y_ref = spmv(A, x), plain_spmv(A, x)
        torch.cuda.synchronize()
        require(y.shape == (n_out,), f"{label} {name}: shape {tuple(y.shape)}")
        rel = float((y - y_ref).abs().max()) / max(
            float(y_ref.abs().max()), 1e-300)
        # a dense core's f32 dot products run to thousands of terms
        op_tol = max(tol, 1e-4) if "dense" in fmt and vdt == torch.float32 else tol
        require(rel <= op_tol, f"{label} {name} ({fmt}) disagrees with its "
                               f"plain evaluation: rel {rel:.3e}")
        total = nbytes + vsz * ((gathered or n_in) + n_out)
        bms, _ = bound_ms(total, 2 * entries, vdt)
        csr = operator_csr(A, n_in, n_out, vdt)
        lib_err = float((csr @ x - y_ref).abs().max()) / max(
            float(y_ref.abs().max()), 1e-300)
        require(lib_err <= op_tol, f"{label} {name}: the CSR yardstick is not "
                                   f"the operator: rel {lib_err:.3e}")
        ms = time_cuda_ms(lambda: spmv(A, x), flush)
        plain_ms = time_cuda_ms(lambda: plain_spmv(A, x), flush, PLAIN_REPS)
        lib_ms = time_cuda_ms(lambda: csr @ x, flush)
        rows.append({"operator": name, "format": fmt, "offsets": noff,
                     "tail_entries": ntail, "bytes": nbytes, "per_cycle": k,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bms, "rel_err": rel})
        log(f"lattice [{label} {name}: {fmt}, {n_out}x{n_in}, {noff} offsets, "
            f"{ntail} tail entries, {nbytes / 1e6:.2f} MB stored, {k}/cycle; "
            f"{card}]: rel err {rel:.2e}; kernels {ms * 1e3:.1f} us, plain "
            f"{plain_ms * 1e3:.1f} us, cuSPARSE CSR ({csr._nnz()} nnz) "
            f"{lib_ms * 1e3:.1f} us, floor {bms * 1e3:.1f} us")
        del csr
    tot = {key: sum(r["per_cycle"] * r[key] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    log(f"lattice [{label}] per V-cycle ({card}), every operator timed alone "
        f"and summed: kernels {tot['ms'] * 1e3:.1f} us, plain "
        f"{tot['plain_ms'] * 1e3:.1f} us, cuSPARSE CSR "
        f"{tot['library_ms'] * 1e3:.1f} us, floor {tot['bound_ms'] * 1e3:.1f} "
        f"us; {sum(r['bytes'] for r in rows) / 1e9:.3f} GB stored")
    return rows


# the forms the V-cycle runs each tailed operator in: A the residual and
# the up-smooth (the down-smooth's A @ 0 is skipped), P the
# prolongation u + P e, R the plain restriction
CYCLE_FORMS = {"A": ("resid", "jacobi"), "P": ("axpy",), "R": ("plain",)}


def row_kernel_tails(A) -> int:
    """K1 launches of A that carry a tail on the row kernel (one offset
    lane): those take its one-row-a-thread instances, which round the
    DIA sum otherwise than the 16-byte instances the same launch without
    a tail takes."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.dia_kernel import offset_lanes

    if isinstance(A, D.DIAWithTail):
        return int(offset_lanes(A.num_rows, len(A.dia.offsets)) == 1)
    if isinstance(A, D.ParityInterpOp) and A.class_tails is not None:
        return sum(1 for m, t in zip(A.mats, A.class_tails) if t is not None
                   and offset_lanes(m.num_rows, len(m.offsets)) == 1)
    if isinstance(A, D.ParityRestrictOp) and A.tail is not None:
        m = A.mats[D._restrict_launches(A)[0]]
        return int(offset_lanes(m.num_rows, len(m.offsets)) == 1)
    return 0


def phase_fused_tails(amg, tol, flush, card, label):
    """K1 with the tail in its launch on every tailed operator of a
    lattice hierarchy, in the forms the cycle runs: against the
    composition it replaced (K1 without the tail, then coo_tail, then
    the torch epilogue; `spmv_tail_after`) bitwise in f64 but for the
    restriction, whose tail is summed first (1e-13), and for a tail on
    the row kernel (`row_kernel_tails`: 1e-13), tol in f32; against
    the plain version (`plain_spmv`, then the epilogue) to tol; the same
    bits on a second run; its launches as `kernel_launches` says.  Timed
    beside the composition and its bound (stored bytes, x, y and the
    form's vectors once).  Returns per-V-cycle sums (ms, composed_ms,
    bound_ms) and the largest abs error against the plain version."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.forms import OPERANDS, epilogue

    rng = np.random.default_rng(31)
    vdt = amg.levels[0].dinv.dtype
    dev = amg.levels[0].dinv.device
    vsz = torch.empty((), dtype=vdt).element_size()
    tot, worst = np.zeros(3), 0.0
    for name, A, n_in, n_out, _ in cycle_operators(amg):
        if getattr(A, "tail", None) is None:
            continue
        _, _, _, _, nbytes, _ = describe(A)
        x = torch.from_numpy(rng.standard_normal(n_in)).to(dev, vdt)
        for form in CYCLE_FORMS[name.split()[-1]]:
            ops = form_operands(form, n_out, vdt, dev, rng)
            fused = lambda: D._spmv_form(A, x, form, **ops)  # noqa: E731
            composed = lambda: epilogue(  # noqa: E731
                form, D.spmv_tail_after(A, x), x, **ops)
            zero_counts()
            y = fused()
            counts = read_counts()
            want = {k: v for k, v in D.kernel_launches(A).items() if v}
            require({k: v for k, v in counts.items() if v} == want,
                    f"{label} {name} {form}: launches {counts}, the operator "
                    f"says {want}")
            y_old = composed()
            y_ref = epilogue(form, plain_spmv(A, x), x, **ops)
            torch.cuda.synchronize()
            scale = max(float(y_ref.abs().max()), 1e-300)
            rel_old = float((y - y_old).abs().max()) / scale
            err = float((y - y_ref).abs().max())
            restrict = isinstance(A, D.ParityRestrictOp)
            if (vdt == torch.float64 and not restrict
                    and not row_kernel_tails(A)):
                require(torch.equal(y, y_old), f"{label} {name} {form}: K1 "
                        f"with its tail is not bitwise K1, coo_tail, epilogue "
                        f"(rel {rel_old:.3e})")
            require(rel_old <= (1e-13 if vdt == torch.float64 else tol),
                    f"{label} {name} {form}: K1 with its tail differs from "
                    f"the composition it replaced: rel {rel_old:.3e}")
            require(err / scale <= tol, f"{label} {name} {form}: K1 with its "
                    f"tail differs from the plain version: rel "
                    f"{err / scale:.3e}")
            require(torch.equal(fused(), y), f"{label} {name} {form}: other "
                                             f"bits on a second run")
            worst = max(worst, err)
            total = nbytes + vsz * (n_in + n_out * (1 + len(OPERANDS[form])))
            bms, _ = bound_ms(total, 2 * describe(A)[3], vdt)
            ms = time_cuda_ms(fused, flush)
            old_ms = time_cuda_ms(composed, flush)
            tot += [ms, old_ms, bms]
            log(f"K1 + tail [{label} {name} {form}: {describe(A)[0]}, "
                f"{A.tail.nnz} tail entries, {want}, on the row kernel "
                f"{row_kernel_tails(A)}; {card}]: vs the "
                f"composition rel {rel_old:.2e} (bitwise "
                f"{torch.equal(y, y_old)}), vs plain rel {err / scale:.2e}; "
                f"fused {ms * 1e3:.1f} us, K1 + coo_tail + epilogue "
                f"{old_ms * 1e3:.1f} us; floor {bms * 1e3:.1f} us")
    log(f"K1 + tail [{label}] per V-cycle ({card}), the tailed operators in "
        f"the cycle's forms: fused {tot[0] * 1e3:.1f} us, composition "
        f"{tot[1] * 1e3:.1f} us, floor {tot[2] * 1e3:.1f} us")
    return tot, worst


def phase_cell_dense(amg, tol, flush, card, label):
    """The collapsed coarse solve (an `on_cells` operator) through the
    cell_dense kernel against its plain version (the gather, torch's
    product, the scatter into zeros): to tol, zeros on the empty cells,
    the same bits on a second run.  Timed beside its bound (M once, the
    indices, the gathered x and y), torch.matmul of M with the gathered
    vector (the library call) and the four calls it replaced (flat_take,
    the product, zeros, index_copy_).  Returns (ms, plain_ms,
    library_ms, bound_ms, bound_by, max_abs_err, unfused_ms, shape)."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.cell_dense_kernel import (
        cell_dense_cuda, cell_dense_reference)
    from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda

    A = amg.levels[-1].coarse_inv
    require(isinstance(A, D.ScatterOp) and A.row_of_cell is not None,
            f"{label}: the coarse solve is {type(A).__name__}, not an "
            f"on_cells operator")
    M, pos, roc = A.inner.inner.data, A.inner.pos, A.row_of_cell
    vdt = amg.levels[0].dinv.dtype
    rng = np.random.default_rng(37)
    x = torch.from_numpy(rng.standard_normal(A.n_out)).to(M.device, vdt)
    y = cell_dense_cuda(M, pos, roc, x)
    y_ref = cell_dense_reference(M, pos, roc, x)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    rel = err / max(float(y_ref.abs().max()), 1e-300)
    require(rel <= tol, f"{label}: cell_dense disagrees with its plain "
                        f"version: rel {rel:.3e}")
    require(not bool(y[roc < 0].any()), f"{label}: cell_dense wrote an "
                                        f"empty cell")
    require(torch.equal(cell_dense_cuda(M, pos, roc, x), y),
            f"{label}: cell_dense gave other bits on a second run")
    rows, cols = M.shape
    vsz = x.element_size()
    nbytes = (tensor_bytes(M, pos, roc) + vsz * (cols + A.n_out))
    bms, by = bound_ms(nbytes, 2 * rows * cols, x.dtype)
    xg = x[pos.long()]
    Mv = M.to(vdt)  # the library's product takes one dtype

    def unfused():
        z = Mv @ flat_take_cuda(x, pos)
        return torch.zeros(A.n_out, dtype=z.dtype, device=z.device
                           ).index_copy_(0, A.pos, z)

    ms = time_cuda_ms(lambda: cell_dense_cuda(M, pos, roc, x), flush)
    plain_ms = time_cuda_ms(lambda: cell_dense_reference(M, pos, roc, x), flush)
    lib_ms = time_cuda_ms(lambda: torch.matmul(Mv, xg), flush)
    un_ms = time_cuda_ms(unfused, flush)
    log(f"cell_dense [{label}: M {rows}x{cols} {M.dtype}, {A.n_out} cells; "
        f"{card}]: rel err {rel:.2e}, empty cells zero; kernel {ms * 1e3:.2f} "
        f"us, plain {plain_ms * 1e3:.2f} us, torch.matmul on the gathered "
        f"vector {lib_ms * 1e3:.2f} us, flat_take + product + zeros + "
        f"index_copy_ {un_ms * 1e3:.2f} us; floor {bms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB)")
    return (ms, plain_ms, lib_ms, bms, by, err, un_ms,
            {"rows": rows, "cols": cols, "cells": A.n_out,
             "dtype": str(M.dtype).split(".")[-1]})


def hierarchy_tails(amg):
    """[(label, COOTail, rows in, rows out, applications per V-cycle)]."""
    out = []
    for name, A, n_in, n_out, k in cycle_operators(amg):
        t = getattr(A, "tail", None)  # DIAWithTail and the parity operators
        if t is not None:
            out.append((name, t, n_in, n_out, k))
    return out


def phase_tail(amg, tol, flush, card, label):
    """`coo_tail` against its plain version on every tail of a lattice
    hierarchy, at the path's shapes: relative error within tol on the
    card, the same bits on a second run (no atomics), and in f64 the
    bits of the CPU's plain version, which sums each row in stored order.
    Timed beside its bound (vals, cols, segment pointers and rows once,
    one x element an entry, y read and written on the rows touched) and
    the three-call torch form (index_select, multiply, index_add_).
    Returns per-V-cycle sums (ms, plain_ms, library_ms, bound_ms,
    "bytes"), the largest abs error and the tails' total entries."""
    from hypre_tpu_torch.ops.tail_kernel import coo_tail_cuda, coo_tail_reference

    rng = np.random.default_rng(23)
    vdt = amg.levels[0].dinv.dtype
    dev = amg.levels[0].dinv.device
    tot, worst, entries = np.zeros(4), 0.0, 0
    for name, t, n_in, n_out, k in hierarchy_tails(amg):
        x = torch.from_numpy(rng.standard_normal(n_in)).to(dev, vdt)
        y0 = torch.from_numpy(rng.standard_normal(n_out)).to(dev, vdt)
        args = (t.vals, t.cols, t.seg_ptr, t.rows_u)
        y = coo_tail_cuda(*args, x, y0.clone())
        y_ref = coo_tail_reference(*args, x, y0.clone())
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        require(rel <= tol, f"coo_tail disagrees with its plain version on "
                            f"{label} {name}: rel {rel:.3e}")
        require(torch.equal(coo_tail_cuda(*args, x, y0.clone()), y),
                f"coo_tail gave other bits on a second run on {label} {name}")
        y_cpu = coo_tail_reference(*(a.cpu() for a in args), x.cpu(), y0.cpu())
        same_card, same_cpu = torch.equal(y, y_ref), torch.equal(y.cpu(), y_cpu)
        if vdt == torch.float64:
            require(same_cpu, f"coo_tail f64 is not bitwise the ordered sum "
                              f"of the CPU's plain version on {label} {name}")
        worst = max(worst, err)
        entries += t.nnz
        nseg = t.rows_u.numel()
        vsz, msz = x.element_size(), t.vals.element_size()
        nbytes = (t.nnz * (msz + 4 + vsz) + 4 * (2 * nseg + 1)
                  + 2 * vsz * nseg)
        bms, _ = bound_ms(nbytes, 2 * t.nnz + nseg, vdt)
        # the three-call form; its bf16 values are widened beforehand
        rows_e = t.rows_u.long()[t.seg.long()]
        vals_w = t.vals.to(vdt)
        y_lib = y0.clone()
        y_k, y_p = y0.clone(), y0.clone()
        ms = time_cuda_ms(lambda: coo_tail_cuda(*args, x, y_k), flush)
        plain_ms = time_cuda_ms(lambda: coo_tail_reference(*args, x, y_p), flush)
        lib_ms = time_cuda_ms(lambda: y_lib.index_add_(
            0, rows_e, vals_w * torch.index_select(x, 0, t.cols)), flush)
        tot += k * np.array([ms, plain_ms, lib_ms, bms])
        seg_max = int(torch.diff(t.seg_ptr).max())
        log(f"coo_tail [{label} {name}: {t.nnz} entries on {nseg} rows, "
            f"longest row {seg_max}, x {n_in}, y {n_out}, {k}/cycle; {card}]: "
            f"rel err {rel:.2e}, bitwise vs the card's plain version "
            f"{same_card}, vs the CPU's {same_cpu}; kernel {ms * 1e3:.2f} us, "
            f"plain {plain_ms * 1e3:.2f} us, index_select * vals -> index_add_ "
            f"{lib_ms * 1e3:.2f} us; floor {bms * 1e3:.2f} us "
            f"({nbytes / 1e6:.3f} MB)")
    log(f"coo_tail [{label}] per V-cycle ({card}): kernel {tot[0] * 1e3:.1f} "
        f"us, plain {tot[1] * 1e3:.1f} us, three-call torch form "
        f"{tot[2] * 1e3:.1f} us, floor {tot[3] * 1e3:.1f} us; {entries} entries")
    return (*tot, "bytes"), worst, entries


def hierarchy_gathers(amg):
    """[(label, pos, table rows, applications per V-cycle)] of every
    GatherOp of a hierarchy."""
    from hypre_tpu_torch.ops.dia import GatherOp, ScatterOp

    out = []
    for name, A, n_in, _, k in cycle_operators(amg):
        while isinstance(A, (GatherOp, ScatterOp)):
            if isinstance(A, GatherOp):
                out.append((name, A.pos, n_in, k))
            A = A.inner
    return out


def phase_path_gathers(amg, flush, card, label):
    """`flat_take` at the shapes the lattice path gives it (every
    GatherOp's x[pos]) against its plain version, bitwise, both forms,
    timed in turns (tiled, elementwise) beside its bound (pos and the
    taken rows in, the result out) and torch.index_select.  Returns
    per-V-cycle sums (ms, plain_ms, library_ms, bound_ms, "bytes",
    earlier_ms) and the shapes."""
    from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda, flat_take_reference

    rng = np.random.default_rng(29)
    vdt = amg.levels[0].dinv.dtype
    tot, shapes = np.zeros(5), []
    for name, pos, n_in, k in hierarchy_gathers(amg):
        x = torch.from_numpy(rng.standard_normal(n_in)).to(pos.device, vdt)
        # the reference and both outputs held at once: no call can be
        # handed a block that holds another's answer
        ref = flat_take_reference(x, pos)
        outs = [flat_take_cuda(x, pos, form=form)
                for form in ("tiled", "elementwise")]
        for form, out in zip(("tiled", "elementwise"), outs):
            require(torch.equal(out, ref),
                    f"flat_take ({form}) differs from its plain version on "
                    f"{label} {name}")
        ne = pos.numel()
        nbytes = ne * (4 + 2 * x.element_size())
        bms, _ = bound_ms(nbytes, 0, vdt)
        ms, earlier_ms, _ = time_in_turns(
            lambda: flat_take_cuda(x, pos),
            lambda: flat_take_cuda(x, pos, form="elementwise"), flush)
        plain_ms = time_cuda_ms(lambda: flat_take_reference(x, pos), flush)
        lib_ms = time_cuda_ms(lambda: torch.index_select(x, 0, pos), flush)
        tot += k * np.array([ms, plain_ms, lib_ms, bms, earlier_ms])
        shapes.append({"operator": name, "table": n_in, "gathers": ne,
                       "dtype": str(vdt).split(".")[-1], "ms": ms,
                       "earlier_ms": earlier_ms})
        log(f"flat_take [{label} {name}: {ne} gathers from {n_in} rows of "
            f"{vdt}, {k}/cycle; {card}]: both forms bitwise equal; in turns "
            f"tiled {ms * 1e3:.2f} us, elementwise (earlier) "
            f"{earlier_ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us, "
            f"torch index_select {lib_ms * 1e3:.2f} us; bound "
            f"{bms * 1e3:.2f} us")
    return (*tot[:4], "bytes", tot[4]), shapes


def hold_ops(ops, tol, label, rng, vdt, dev) -> dict:
    """Each operator [(name, A, rows in, rows out, forms)] in each of its
    forms through its wrappers, against the plain version on the same
    inputs (`plain_spmv`, then the torch epilogue): relative error within
    tol (1e-4 for a dense product in float32, whose dot products run to
    thousands of terms), the same bits on a second run, and the launches
    of each application exactly what `kernel_launches` says of it.
    Untimed.  Returns {"applications", "max_rel", "launches"}: the
    launches of these comparisons, not of a solve."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.forms import epilogue

    n_apps, worst = 0, 0.0
    total = {name: 0 for name in read_counts()}
    for name, A, n_in, n_out, forms in ops:
        fmt = describe(A)[0]
        x = torch.from_numpy(rng.standard_normal(n_in)).to(dev, vdt)
        want = {k: v for k, v in D.kernel_launches(A).items() if v}
        op_tol = (max(tol, 1e-4) if "dense" in fmt and vdt == torch.float32
                  else tol)
        for form in forms:
            vecs = form_operands(form, n_out, vdt, dev, rng)
            zero_counts()
            y = D._spmv_form(A, x, form, **vecs)
            counts = read_counts()
            y_ref = epilogue(form, plain_spmv(A, x), x, **vecs)
            torch.cuda.synchronize()
            require(y.shape == (n_out,) and bool(torch.isfinite(y).all()),
                    f"{label} {name} {form}: shape {tuple(y.shape)} or a "
                    f"non-finite value")
            rel = float((y - y_ref).abs().max()) / max(
                float(y_ref.abs().max()), 1e-300)
            require(rel <= op_tol, f"{label} {name} ({fmt}) {form} disagrees "
                                   f"with its plain version: rel {rel:.3e} "
                                   f"(tol {op_tol:g})")
            got = {k: v for k, v in counts.items() if v}
            require(got == want, f"{label} {name} {form}: launches {got}, the "
                                 f"operator says {want}")
            require(torch.equal(D._spmv_form(A, x, form, **vecs), y),
                    f"{label} {name} {form}: other bits on a second run")
            for k, v in counts.items():
                total[k] += v
            n_apps += 1
            worst = max(worst, rel)
    log(f"operators [{label}]: {n_apps} applications of "
        f"{[(o[0], describe(o[1])[0]) for o in ops]} agree with their plain "
        f"versions, max rel {worst:.2e} (tol {tol:g}), launches as "
        f"`kernel_launches` says: { {k: v for k, v in total.items() if v} }")
    return {"applications": n_apps, "max_rel": worst,
            "launches": {k: v for k, v in total.items() if v}}


def phase_hold_operators(amg, tol, label):
    """`hold_ops` on every operator of a frozen hierarchy (plain or
    lattice forms) in each form the V-cycle runs it (CYCLE_FORMS; the
    coarse solve plain).  So K1 (with and without a tail), the ELL
    kernel, `flat_take` and `cell_dense` are held at the shapes this
    hierarchy gives them."""
    ops = [(name, A, n_in, n_out, CYCLE_FORMS.get(name.split()[-1], ("plain",)))
           for name, A, n_in, n_out, _ in cycle_operators(amg)]
    return hold_ops(ops, tol, label, np.random.default_rng(41),
                    amg.levels[0].dinv.dtype, amg.levels[0].dinv.device)


def run_lattice(nx, opts, dev, card, label, iters_ok, plain_k1: int):
    """Drive the lattice path once at nx^3 with the counts set to 0 just
    before and read just after; require convergence in an allowed
    iteration count, a right solution, and every DIA part, tail and
    gather of the path on its kernel, counted exactly.  Returns (amg,
    result, launches, setup_s, solve_s)."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(nx, opts, dev)
    counts = read_counts()
    log(f"launches in the lattice {label} {nx}^3 run: {counts}")
    log(f"setup phases, lattice {label} {nx}^3 (host clock; FREEZE and "
        f"COLLAPSE synchronize the card):")
    for line in GLOBAL_TIMER.summary().splitlines():
        log(f"  {line}")
    n = nx**3
    rel, bound = check_solution(amg, res, n)
    levels = "; ".join(
        f"L{l} A {describe(lvl.A)[0]} {lvl.dinv.shape[0]}"
        + (f", P {describe(lvl.P)[0]}" if lvl.P is not None else "")
        for l, lvl in enumerate(amg.levels))
    ci = amg.levels[-1].coarse_inv
    coarse = ("dense pinv" if isinstance(ci, torch.Tensor)
              else f"collapsed sub-cycle as {describe(ci)[0]}")
    expected = expected_launches(amg, res.num_iterations)
    log(f"lattice {label} {nx}^3 ({card}): levels [{levels}], coarse solve "
        f"{coarse} (setup hierarchy: {len(amg._host_A)} levels); setup "
        f"{setup_s:.2f} s, solve {solve_s:.4f} s ({n / solve_s:.4g} DOF/s), "
        f"{res.num_iterations} iterations, final rel residual "
        f"{float(res.rel_residual_norm):.3e} (true, in f64: {rel:.3e}, bound "
        f"{bound:.1e}); expected launches {expected}")
    require(res.converged and res.num_iterations in iters_ok,
            f"lattice {label}: {res.num_iterations} iterations, expected one "
            f"of {sorted(iters_ok)}; residual history "
            f"{res.res_norms[:res.num_iterations + 1].tolist()}")
    require(counts == expected,
            f"lattice {label}: launches {counts} are not the path's "
            f"operators' {expected}: a matvec left its kernel")
    require(counts["dia_spmv"] > plain_k1 and counts["dia_spmv_tail"] > 0
            and counts["cell_dense"] > 0,
            f"lattice {label}: K1 {counts['dia_spmv']} (plain path "
            f"{plain_k1}), K1 with a tail {counts['dia_spmv_tail']}, "
            f"cell_dense {counts['cell_dense']}: the lattice forms did not "
            f"engage")
    require(counts["coo_tail"] == 0 and counts["flat_take"] == 0,
            f"lattice {label}: coo_tail {counts['coo_tail']}, flat_take "
            f"{counts['flat_take']}: a tail or the coarse solve's gather "
            f"left the fused kernels")
    cycles = res.num_iterations + 1
    log(f"lattice {label}: per V-cycle K1 {counts['dia_spmv'] / cycles:g}, "
        f"of them with a tail {counts['dia_spmv_tail'] / cycles:g}, "
        f"cell_dense {counts['cell_dense'] / cycles:g}")
    return amg, res, counts, setup_s, solve_s


# the JAX package's count on the CPU: ext+i, 48^3, f64, the plain forms,
# the bench protocol (tests/test_torch_ext_interp.py pins the same)
EXT48_F64 = 12


def level_lines(amg):
    """Per frozen level: A's form, rows, offsets, stored bytes, and the
    forms of P and R."""
    out = []
    for l, lvl in enumerate(amg.levels):
        fmt, noff, ntail, _, nb, _ = describe(lvl.A)
        line = (f"L{l} A {fmt} {lvl.dinv.shape[0]} rows, {noff} offsets"
                + (f" + {ntail} tail entries" if ntail else "")
                + f", {nb / 1e6:.1f} MB")
        for name in ("P", "R"):
            M = getattr(lvl, name)
            if M is not None:
                f, o, _, _, b, _ = describe(M)
                line += f"; {name} {f}, {o} offsets, {b / 1e6:.1f} MB"
        out.append(line)
    ci = amg.levels[-1].coarse_inv
    out.append("coarse solve: " + ("dense pinv" if isinstance(ci, torch.Tensor)
                                   else f"collapsed sub-cycle, {describe(ci)[0]}"))
    return out


def gates(amg) -> dict:
    """Which of the lattice forms' gates fired in a frozen hierarchy."""
    n0 = amg._host_A[0].shape[0]
    embedded = len(amg.levels) > 1 and amg.levels[1].dinv.shape[0] == n0
    l1 = describe(amg.levels[1].A) if embedded else None
    return {
        "embed_level1": embedded,
        "level1_offsets": l1[1] if l1 else None,
        "max_embedded_offsets": amg.opts.max_embedded_offsets,
        "device_rap": embedded and amg.opts.device_rap,
        "relocated_levels": sorted(amg._reloc_cells),
        "relocate_max_bytes": amg.opts.relocate_max_bytes,
        "collapsed": len(amg.levels) < len(amg._host_A),
        "setup_levels": len(amg._host_A),
    }


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps, entrywise: the bit patterns as integers
    ordered like the values."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(a) - ordered(b)).abs()


def phase_entry(card):
    """(a) `hypre_tpu_torch.entry.entry()` on the card and on the CPU:
    the same relative residual norm within 1e-3 relative and x within
    1e-4 (float32 vectors, reductions ordered otherwise on the two
    devices); level-1 A from the device RAP within 1 bf16 ulp of the
    CPU's (the differing entries printed); the step's ten PCG iterations (tol 1e-8 is not reached)
    launch exactly what `kernel_launches` says of the hierarchy, K1 among
    them.  Returns the card run's numbers."""
    from hypre_tpu_torch.entry import entry

    zero_counts()
    t0 = time.perf_counter()
    step, (b,) = entry(device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, r = step(b)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = read_counts()
    amg = step.amg
    step_c, (b_c,) = entry(device="cpu")
    x_c, r_c = step_c(b_c)
    r, r_c = float(r), float(r_c)
    dx = float((x.cpu() - x_c).abs().max())
    forms = [describe(l.A)[0] for l in amg.levels]
    expected = expected_launches(amg, 10, two_norm=False)
    for line in level_lines(amg):
        log(f"entry() levels ({card}): {line}")
    log(f"entry() ({card}): setup {setup_s:.2f} s, step {step_s * 1e3:.1f} ms; "
        f"rel residual norm card {r:.6e}, CPU {r_c:.6e} (rel diff "
        f"{abs(r - r_c) / r_c:.2e}); max diff of x {dx:.2e}; gates "
        f"{gates(amg)}; launches {counts} (expected {expected})")
    require(forms == [describe(l.A)[0] for l in step_c.amg.levels],
            "entry(): the card's hierarchy differs from the CPU's")
    # the device RAP's level-1 A: the same IEEE operations on both devices
    a1, a1_c = amg.levels[1].A, step_c.amg.levels[1].A
    ulps = bf16_ulps(a1.data.cpu(), a1_c.data)
    log(f"entry(): device RAP L1 A ({len(a1.offsets)} offsets, bf16) card "
        f"vs CPU: {int((ulps > 0).sum())} of {ulps.numel()} entries differ, "
        f"at most {int(ulps.max())} ulp")
    require(a1.offsets == a1_c.offsets and int(ulps.max()) <= 1,
            "entry(): the device RAP differs between the card and the CPU")
    require(1e-8 < r_c < 1e-6 and abs(r - r_c) <= 1e-3 * r_c and dx <= 1e-4,
            "entry(): the card's step differs from the CPU's")
    require(counts == expected and counts["dia_spmv"] > 0,
            f"entry(): launches {counts} are not the hierarchy's {expected}")
    held = phase_hold_operators(amg, 1e-5, "entry() f32/bf16")
    return {"setup_s": setup_s, "step_s": step_s, "rel_residual_norm": r,
            "cpu_rel_residual_norm": r_c, "forms": forms, "launches": counts,
            "held": held}


def median_s(fn, reps: int = 3) -> float:
    """Median host seconds of fn() with the card synchronized."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def freeze_again(amg, device_rap: bool) -> dict:
    """Freeze the same host hierarchy again with device_rap set: the
    phases' seconds (GLOBAL_TIMER, the card synchronized)."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    amg.opts = dataclasses.replace(amg.opts, device_rap=device_rap)
    amg.levels, amg._reloc_cells = [], {}
    torch.cuda.empty_cache()
    GLOBAL_TIMER.clear()
    amg._freeze_hierarchy()
    return {k: GLOBAL_TIMER.seconds(k)
            for k in ("FREEZE", "DEVICE_RAP", "COLLAPSE")}


def phase_device_rap(amg, card, label):
    """(b) The device RAP on a frozen 96^3 lattice hierarchy.  Level-1 A
    from the device pass against `build_embedded_dia` of the same host
    A1 (what the host branch stores): the same offsets; in f64 each
    off-diagonal entry within 1e-12 of the host value, relative, where
    the host holds 0 within 8 eps of the largest entry, and the diagonal
    row within 2^-24 (the pass reads the diagonal back through float32
    before it adds the lumped mass, as the JAX package's does); in bf16
    the entries that differ and by how many ulps, printed.  In both, the
    same pass on the CPU over the same inputs gives the card's bits
    (level-1 A and the transposed level-0 R).  Then the pass alone
    (transpose + product) against the host branch's build of level-1 A
    and level-0 R, medians of 3, the pass's peak memory beyond its
    inputs (outputs and scratch, at most 2 GB), and FREEZE (which
    includes DEVICE_RAP) / DEVICE_RAP / COLLAPSE seconds of both
    branches from freezing the same host hierarchy again, once each
    (phase 11 gives one timed round of the whole setup; the hierarchy ends
    frozen with the device RAP)."""
    from hypre_tpu_torch.ops.device_rap import (dia_transpose_device,
                                                embedded_rap_device)
    from hypre_tpu_torch.ops.dia import build_embedded_dia

    dev = amg.device
    A1h, P0h = amg._host_A[1], amg._host_P[0]
    n0 = amg._host_A[0].shape[0]
    cpos0 = np.flatnonzero(amg._cf[0] > 0).astype(np.int64)
    idx = np.arange(n0, dtype=np.int64)
    p = amg._device_rap_plan(cpos0)
    mdt = p["mdt"]
    A1d, P0, A0 = amg.levels[1].A, amg.levels[0].P, amg.levels[0].A
    host = build_embedded_dia(A1h, cpos0, cpos0, n0, mdt, dev)
    require(A1d.offsets == host.offsets,
            f"{label}: device RAP offsets differ from the host product's")
    k0 = A1d.offsets.index(0)
    d, h = A1d.data, host.data
    out = {"offsets": len(A1d.offsets), "terms": int(p["plan"]["valid"].sum()),
           "tmax": int(p["plan"]["tmax"])}
    if mdt == torch.float64:
        diff = (d - h).abs()
        diag_rel = float((diff[k0] / h[k0].abs().clamp_min(1e-300)).max())
        diff[k0] = 0
        # per entry: relative to the host value where it is nonzero; where
        # the host product holds 0 (a pattern entry summed to 0, or no
        # entry) the pass may leave a cancellation residue of a few ulps
        # of the operator's scale, no more
        nz = h != 0
        off_rel = float((diff[nz] / h[nz].abs()).max())
        scale = float(h.abs().max())
        resid = float(diff[~nz].max()) / scale if bool((~nz).any()) else 0.0
        differ = int((d != h).sum())
        log(f"device RAP [{label}] L1 A vs the host product: {out['offsets']} "
            f"offsets, {differ} of {d.numel()} entries differ; off-diagonal "
            f"entries max rel per entry {off_rel:.2e} (tol 1e-12), where the "
            f"host holds 0 at most {resid:.2e} of the largest entry (tol "
            f"8 eps = {8 * 2.0**-52:.2e}); diagonal row max rel {diag_rel:.2e} "
            f"(tol 2^-24 = {2.0**-24:.2e})")
        require(off_rel <= 1e-12 and resid <= 8 * 2.0**-52
                and diag_rel <= 2.0**-24,
                f"{label}: the device RAP's L1 A is not the host product")
        out.update(differ=differ, offdiag_max_rel=off_rel,
                   zero_residue_rel=resid, diag_max_rel=diag_rel)
    else:
        ulps = bf16_ulps(d, h)
        hist = {u: int((ulps == u).sum()) for u in (1, 2)}
        hist[">2"] = int((ulps > 2).sum())
        differ = int((ulps > 0).sum())
        log(f"device RAP [{label}] L1 A vs the host product: {out['offsets']} "
            f"offsets, {differ} of {d.numel()} bf16 entries differ, by ulps "
            f"{hist}, at most {int(ulps.max())}")
        out.update(differ=differ, ulps=hist, max_ulps=int(ulps.max()))
    del host, d, h
    # the same pass on the CPU over the same inputs: the same gathers,
    # IEEE products and sums in one order, so the same bits (level-1 A
    # and level-0 R, the transpose)
    t0 = time.perf_counter()
    P0c, A0c = (dataclasses.replace(M, data=M.data.cpu()) for M in (P0, A0))
    A1c, _, _ = embedded_rap_device(P0c, A0c, p["plan"], p["tol"], mdt)
    R0c = dia_transpose_device(P0c)
    cpu_s = time.perf_counter() - t0
    R0 = amg.levels[0].R
    same = (torch.equal(A1d.data.cpu(), A1c)
            and R0.offsets == R0c.offsets and torch.equal(R0.data.cpu(), R0c.data))
    log(f"device RAP [{label}] card vs the same pass on the CPU ({cpu_s:.1f} "
        f"s there): L1 A and L0 R bitwise equal {same}")
    require(same, f"{label}: the device RAP on the card differs from the "
                  f"same pass on the CPU")
    out["cpu_bitwise"] = same
    del P0c, A0c, A1c, R0c

    def device_pass():
        dia_transpose_device(P0)
        embedded_rap_device(P0, A0, p["plan"], p["tol"], mdt)

    def host_build():
        build_embedded_dia(A1h, cpos0, cpos0, n0, mdt, dev)
        build_embedded_dia(P0h.T.tocsr(), cpos0, idx, n0, mdt, dev)

    dev_s, host_s = median_s(device_pass), median_s(host_build)
    torch.cuda.reset_peak_memory_stats(dev)
    m0 = torch.cuda.memory_allocated(dev)
    device_pass()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - m0
    require(peak <= 2e9, f"{label}: the device RAP took {peak / 1e9:.2f} GB "
                         f"beyond its inputs, more than 2 GB")
    med = {("device" if flag else "host"): freeze_again(amg, flag)
           for flag in (False, True)}
    log(f"device RAP [{label}; {card}]: {out['terms']} terms (at most "
        f"{out['tmax']} an offset) into {out['offsets']} offsets; the pass "
        f"(transpose + product) {dev_s:.4f} s, the host branch's L1 A + L0 R "
        f"build {host_s:.4f} s, medians of 3; peak memory of the pass beyond "
        f"its inputs {peak / 1e9:.3f} GB; freezing again: {med}")
    out.update(device_pass_s=dev_s, host_build_s=host_s, peak_bytes=peak,
               freeze=med)
    return out


def run_ext(nx, opts, dev, card, label):
    """(c) One ext+i run at nx^3 through run_slice, the counts set to 0
    just before and read just after: convergence, a right solution,
    launches exactly as `kernel_launches` says; then one more solve
    under torch.profiler for device busy time and kernels an iteration.
    Prints the levels, the gates and the setup phases.  Returns the
    numbers."""
    from hypre_tpu_torch.profile_slice import profile_solve
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(nx, opts, dev)
    counts = read_counts()
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in (
        "SETUP", "STRENGTH", "COARSEN", "INTERP", "RAP", "FREEZE",
        "DEVICE_RAP", "COLLAPSE")}
    rel, bound = check_solution(amg, res, nx**3)
    expected = expected_launches(amg, res.num_iterations)
    _, wall, busy_us, events, _ = profile_solve(make_solve(amg), cpu=False)
    its = res.num_iterations
    for line in level_lines(amg):
        log(f"ext+i [{label}] levels: {line}")
    g = gates(amg)
    log(f"ext+i [{label} {nx}^3; {card}]: {its} iterations, final rel "
        f"residual {float(res.rel_residual_norm):.3e} (true, in f64: "
        f"{rel:.3e}, bound {bound:.1e}); setup {setup_s:.2f} s (phases "
        f"{phases}); solve {solve_s * 1e3:.2f} ms; under the profiler wall "
        f"{wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms (idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.1f}%), {len(events)} device "
        f"events ({len(events) / max(its, 1):.0f} an iteration); gates {g}; "
        f"launches {counts}")
    require(res.converged, f"ext+i {label}: did not converge")
    require(counts == expected, f"ext+i {label}: launches {counts} are not "
                                f"the hierarchy's {expected}")
    held = phase_hold_operators(
        amg, 1e-12 if opts.dtype == "float64" else 1e-5, f"ext+i {label}")
    return {"iterations": its, "setup_s": setup_s, "solve_s": solve_s,
            "busy_ms": busy_us / 1e3, "wall_ms": wall * 1e3,
            "kernels_per_iteration": len(events) / max(its, 1),
            "phases": phases, "gates": g, "launches": counts, "held": held}


def phase_ext(dev, card):
    """(c) Extended+i interpolation on the card: at 48^3 f64 on the plain
    forms exactly the JAX package's count (EXT48_F64); at 96^3 in f64
    and in f32/bf16 (nongalerkin_tol 0.02) the plain forms and the
    lattice forms with the device RAP, the same count in f64 and within
    one in f32/bf16.  Returns {label: numbers}."""
    out = {"48^3 plain f64": run_ext(
        48, slice_options("ext+i", dtype="float64"), dev, card,
        "48^3 plain f64")}
    require(out["48^3 plain f64"]["iterations"] == EXT48_F64,
            f"ext+i 48^3 f64: {out['48^3 plain f64']['iterations']} "
            f"iterations, the JAX package's {EXT48_F64}")
    for tag, kw in (("f64", dict(dtype="float64")),
                    ("f32/bf16", dict(dtype="float32", mat_dtype="bfloat16",
                                      nongalerkin_tol=0.02))):
        for forms, opts in (("plain", slice_options("ext+i", **kw)),
                            ("lattice", lattice_options(NX, "ext+i", **kw))):
            label = f"96^3 {forms} {tag}"
            out[label] = run_ext(NX, opts, dev, card, label)
            torch.cuda.empty_cache()
        its = (out[f"96^3 plain {tag}"]["iterations"],
               out[f"96^3 lattice {tag}"]["iterations"])
        require(abs(its[0] - its[1]) <= (tag != "f64"),
                f"ext+i 96^3 {tag}: plain {its[0]} and lattice {its[1]} "
                f"iterations")
    return out



# -- bench.py's device-resident level-0 setup (device_setup) ----------------

# the JAX package's PCG counts on the CPU with the device setup chain at
# 96^3: bench.py's options (device_setup, lattice_coeffs (1, 1, 1), the
# lattice defaults, classical, P_max_elmts 4, relax 18), b = ones,
# two-norm, tol 1e-6; recomputed by
#   python -m pytest -m slow tests/test_torch_device_setup.py -k jax_count
DS96_F64 = 25
DS96_F32 = 21
# the chain's timers (DS_PHASES), then the host setup's and the freeze's
SETUP_PHASES = DS_PHASES + ("SETUP", "STRENGTH", "COARSEN", "INTERP", "RAP",
                            "FREEZE", "DEVICE_RAP", "COLLAPSE")
DS_ROUNDS = 1  # setups a path (3 until phase 18 came, 2 until phase 19)


def ds_options(**kw):
    """bench.py's 96^3 options: the lattice defaults with the device
    setup chain, the fine table built on the card."""
    return lattice_options(NX, device_setup=True,
                           lattice_coeffs=(1.0, 1.0, 1.0), **kw)


def first_solution(opts, dev):
    """Setup + one solve through run_slice: (amg, result, {phase:
    seconds} of GLOBAL_TIMER with "rest of SETUP" (SETUP less the
    chain's phases), setup_s, solve_s and first_solution_s)."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    amg, res, setup_s, solve_s = run_slice(NX, opts, dev)
    ph = {k: GLOBAL_TIMER.seconds(k) for k in SETUP_PHASES}
    ph["rest of SETUP"] = ph["SETUP"] - sum(ph[k] for k in DS_PHASES)
    ph.update(setup_s=setup_s, solve_s=solve_s,
              first_solution_s=setup_s + solve_s)
    return amg, res, ph


def hold_chain_on_cpu(amg, opts, label):
    """The chain on the card against the same chain on the CPU over the
    same 96^3 inputs (BoomerAMG._device_setup_level0 of an instance on
    the CPU): the device CF bitwise `lattice_pmis_host`'s and the CPU
    run's; P0 and level-1 A with the same offsets, f64 within 1e-14
    relative per entry, f32 within 4 ulp (level-1 A as the card's level
    holds it, in mat_dtype: bf16 within 1 ulp); the compact level-1 A
    the host continues from likewise.  Returns the differences."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG
    from hypre_tpu_torch.solvers.amg.device_coarsen import lattice_pmis_host

    f = amg._fast
    n = NX**3
    cf0 = amg._cf[0]
    P = f["P"]
    cf_np = lattice_pmis_host(amg.levels[0].A.data.cpu().numpy(),
                              amg.levels[0].A.offsets, n, seed=opts.seed,
                              theta=opts.strong_threshold,
                              max_row_sum=opts.max_row_sum)
    require(np.array_equal(cf_np.astype(np.int64), cf0),
            f"{label}: the card's CF differs from lattice_pmis_host's")
    t0 = time.perf_counter()
    cpu = BoomerAMG.__new__(BoomerAMG)
    cpu.opts, cpu.device = opts, torch.device("cpu")
    fc = cpu._device_setup_level0(amg._host_A[0])
    cpu_s = time.perf_counter() - t0
    require(np.array_equal(fc["cf0"], cf0), f"{label}: CF card != CPU")
    f32 = P.data.dtype == torch.float32

    def diff(a, b, what):
        """(entries that differ, max rel per entry or max f32 ulps)."""
        a, b = a.cpu(), b.cpu()
        differ = int((a != b).sum())
        if a.dtype == torch.bfloat16:
            worst = int(bf16_ulps(a, b).max())
            ok = worst <= 1
        elif f32:
            ia, ib = (t.view(torch.int32).long() for t in (a, b))
            ia, ib = (torch.where(t < 0, -(t & 0x7FFFFFFF), t) for t in (ia, ib))
            worst = int((ia - ib).abs().max())
            ok = worst <= 4
        else:
            nz = b != 0
            worst = float(((a - b).abs()[nz] / b.abs()[nz]).max())
            ok = worst <= 1e-14 and bool((a[~nz] == 0).all())
        require(ok, f"{label}: {what} on the card differs from the CPU run "
                    f"({differ} entries, worst {worst})")
        return {"differ": differ, "of": a.numel(),
                ("max_ulps" if (f32 or a.dtype == torch.bfloat16)
                 else "max_rel"): worst}

    require(P.offsets == fc["P"].offsets, f"{label}: P0 offsets differ")
    L1 = amg.levels[1].A
    require(L1.offsets == fc["A1"].offsets, f"{label}: level-1 offsets differ")
    A1h, A1c = amg._host_A[1], fc["A1_host"]
    require(A1h.shape == A1c.shape and np.array_equal(A1h.indptr, A1c.indptr)
            and np.array_equal(A1h.indices, A1c.indices),
            f"{label}: the compact level-1 pattern differs")
    host_vals = (torch.from_numpy(A1h.data), torch.from_numpy(A1c.data))
    if f32:  # f32 values carried in f64
        host_vals = tuple(v.float() for v in host_vals)
    out = {"cpu_chain_s": cpu_s,
           "P0": diff(P.data, fc["P"].data, "P0"),
           "A1": diff(L1.data, fc["A1"].data.to(L1.data.dtype), "level-1 A"),
           "A1_host": diff(*host_vals, "the compact level-1 A"),
           "P0_offsets": len(P.offsets), "A1_offsets": len(L1.offsets)}
    log(f"device setup [{label}]: CF bitwise lattice_pmis_host's and the CPU "
        f"chain's ({int((cf0 > 0).sum())} C points); card vs the CPU chain "
        f"({cpu_s:.1f} s there): {out}")
    return out


def phase_device_setup(dev, card):
    """bench.py's 96^3 configuration with the device setup chain, f64 and
    f32/bf16/ngt 0.02: each driven once through run_slice with the counts
    at 0 just before and read just after: the chain engaged (amg._fast),
    the JAX package's count (DS96_F64 / DS96_F32), a right solution,
    launches exactly as `kernel_launches` says; the chain held against
    its CPU run (`hold_chain_on_cpu`); the solve's median of 3 warm
    solves, device busy and kernels an iteration (torch.profiler); then
    setup by phase and time to a first solution (setup + one solve),
    medians of DS_ROUNDS, in turns with the same options with
    device_setup=False (the host setup, the device RAP) and the plain
    path the port recommends.  Returns {label: numbers}."""
    from hypre_tpu_torch.profile_slice import profile_solve

    out = {}
    for tag, kw, want in (
            ("f64", dict(dtype="float64"), DS96_F64),
            ("f32/bf16", dict(dtype="float32", mat_dtype="bfloat16",
                              nongalerkin_tol=0.02), DS96_F32)):
        opts = ds_options(**kw)
        zero_counts()
        amg, res, ph = first_solution(opts, dev)
        counts = read_counts()
        its = res.num_iterations
        require(amg._fast is not None,
                f"device setup {tag}: the chain did not engage")
        rel, bound = check_solution(amg, res, NX**3)
        expected = expected_launches(amg, its)
        require(res.converged and its == want,
                f"device setup {tag}: {its} iterations, the JAX package's "
                f"{want}; residual history "
                f"{res.res_norms[:its + 1].tolist()}")
        require(counts == expected and counts["dia_spmv"] > 0,
                f"device setup {tag}: launches {counts} are not the "
                f"hierarchy's {expected}")
        held = hold_chain_on_cpu(amg, opts, tag)
        solve = make_solve(amg)
        solve()
        times = []
        for _ in range(MEDIAN_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            solve()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        _, wall, busy_us, events, _ = profile_solve(solve, cpu=False)
        levels = level_lines(amg)
        per_cycle = amg.cycle_launches()
        del amg, res, solve
        torch.cuda.empty_cache()
        # setup by phase and the first solution, in turns
        paths = {"device setup": opts,
                 "host setup": dataclasses.replace(
                     opts, device_setup=False, lattice_coeffs=None),
                 "plain": slice_options(**kw)}
        runs = {name: [] for name in paths}
        runs["device setup"].append(ph)
        for r in range(DS_ROUNDS):
            for name, o in paths.items():
                if name == "device setup" and r == 0:
                    continue  # the counted run above
                amg, res, ph_r = first_solution(o, dev)
                require(res.converged, f"{name} {tag}: did not converge")
                require((amg._fast is not None) == (name == "device setup"),
                        f"{name} {tag}: the chain engaged where it should "
                        f"not, or not where it should")
                ph_r["iterations"] = res.num_iterations
                runs[name].append(ph_r)
                del amg, res
                torch.cuda.empty_cache()
        med = {name: {k: float(np.median([r[k] for r in rs])) for k in rs[0]
                      if k != "iterations"} for name, rs in runs.items()}
        for line in levels:
            log(f"device setup [{tag}] levels: {line}")
        o = {"iterations": its, "rel_residual_norm": float(rel),
             "solve_median_ms": float(np.median(times)),
             "solve_min_ms": min(times), "solve_max_ms": max(times),
             "busy_ms": busy_us / 1e3, "wall_ms": wall * 1e3,
             "idle_share": 1 - busy_us / 1e6 / wall,
             "kernels_per_iteration": len(events) / max(its, 1),
             "per_cycle": per_cycle, "launches": counts, "held": held,
             "medians": med,
             "iterations_by_path": {k: [r.get("iterations", its) for r in v]
                                    for k, v in runs.items()}}
        log(f"device setup [{tag} 96^3; {card}]: {its} iterations (JAX "
            f"package: {want}), true rel residual {rel:.3e} (bound "
            f"{bound:.1e}); solve median of {MEDIAN_REPS} {o['solve_median_ms']:.2f} ms "
            f"({o['solve_min_ms']:.2f}-{o['solve_max_ms']:.2f}); under the "
            f"profiler wall {wall * 1e3:.2f} ms, device busy "
            f"{busy_us / 1e3:.2f} ms (idle {100 * o['idle_share']:.1f}%), "
            f"{o['kernels_per_iteration']:.0f} kernels an iteration; per "
            f"V-cycle {per_cycle}; launches {counts}")
        for name, m in med.items():
            log(f"device setup [{tag}] {name}, medians of "
                f"{len(runs[name])} (s): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in m.items()))
        out[tag] = o
    return out


# -- the Gauss-Seidel family (relax 13 / 14, the BoomerAMGOptions() defaults)

# the JAX package's counts on the CPU (hypre_tpu, the plain forms, PCG
# two-norm, tol 1e-6, b = ones; recomputed with hypre_tpu.solvers.amg):
# relax 13 / 14 at 96^3 in f64 and with f32 vectors, bf16 matrices and
# nongalerkin_tol 0.02; BoomerAMGOptions() at 24^3 (f64); relax 16 at 48^3
GS96_F64 = 17
GS96_F32 = 13
DEFAULT24_F64 = 10
CHEBY48_F64 = 13
GS_W, GS_OMEGA = 0.9, 0.8  # the sweep forms held: plain (w) and omega


def gs_schedules(amg):
    """[(label, schedule)] of a hierarchy: every level's forward and
    backward schedules (or their C / F halves)."""
    out = []
    for l, lvl in enumerate(amg.levels):
        for d, S in (("fwd", lvl.gs_fwd), ("bwd", lvl.gs_bwd)):
            if isinstance(S, tuple):
                out += [(f"L{l} {d} C", S[0]), (f"L{l} {d} F", S[1])]
            elif S is not None:
                out.append((f"L{l} {d}", S))
    return out


def gs_bytes(amg) -> int:
    """Bytes of the hierarchy's GS layout on the card (each level's shared
    CSR and divisor once, and every schedule)."""
    mats = {id(S.mat): S.mat for _, S in gs_schedules(amg)}
    return (sum(m.nbytes() for m in mats.values())
            + sum(S.nbytes() for _, S in gs_schedules(amg)))


def require_no_gs_fault(dev, where: str) -> None:
    """The device's GS fault word after a synchronize: 0, or the phase
    fails (a sync-free wait gave up)."""
    from hypre_tpu_torch.ops.gs_kernel import read_fault

    torch.cuda.synchronize()
    code = read_fault(dev)
    require(code == 0, f"{where}: a sync-free gs_sweep wait gave up (fault "
                       f"word {code}: 1 + the slot of the row)")


def hold_gs(sched, label, vdt, tol, rng, forms=("plain", "omega"),
            grids=(False, True)):
    """The sync-free form against the plain version on one schedule, each
    sweep form (plain: w = GS_W; omega: w = GS_W, omega = GS_OMEGA with a
    separate v), relative to max |u| within tol, the same bits twice, and
    bitwise the wavefront form at the same lanes a row in each of its
    grid variants asked for (False: one block, True: the cooperative
    grid); the fault word 0.
    Returns (the largest absolute error, bitwise comparisons made)."""
    from hypre_tpu_torch.ops.gs_kernel import (
        free_lanes, gs_sweep_cuda, gs_sweep_reference)

    dev = sched.order.device
    n = sched.n
    u, f, v = (torch.from_numpy(rng.standard_normal(n)).to(dev, vdt)
               for _ in range(3))
    slabs = sched.slabs(dev)
    lanes = free_lanes(sched.max_row)  # the wrapper's sync-free pick
    worst, same = 0.0, 0
    for form in forms:
        om = 1.0 if form == "plain" else GS_OMEGA
        vv = None if form == "plain" else v
        want = gs_sweep_reference(slabs, n, u, f, GS_W, om, vv)
        got = gs_sweep_cuda(sched, u, f, GS_W, om, vv, form="syncfree",
                            lanes=lanes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / max(float(want.abs().max()), 1e-300)
        require(rel <= tol, f"gs_sweep {label} {form} disagrees with its "
                            f"plain version: rel {rel:.3e} (tol {tol:g})")
        worst = max(worst, err)
        require(torch.equal(gs_sweep_cuda(sched, u, f, GS_W, om, vv,
                                          form="syncfree", lanes=lanes), got),
                f"gs_sweep {label} {form}: other bits on a second run")
        for coop in grids:
            ref = gs_sweep_cuda(sched, u, f, GS_W, om, vv, form="wavefront",
                                coop=coop, lanes=lanes)
            require(torch.equal(got, ref),
                    f"gs_sweep {label} {form}: the sync-free form is not the "
                    f"wavefront form's ({'grid' if coop else 'one block'}, "
                    f"{lanes} lanes) bit for bit: max diff "
                    f"{float((got - ref).abs().max()):.3e}")
            same += 1
    require_no_gs_fault(dev, f"gs_sweep {label}")
    return worst, same


def phase_gs_step(dev, card):
    """t_step, one cross-SM step of the sync-free sweep (publish a value
    with its epoch, poll it from another SM), by the two-SM ping-pong
    probe: the median of 5 probes of 20,000 round trips; beside it the
    same for the flag design it replaced (release a flag, acquire poll,
    L2 load of the value)."""
    from hypre_tpu_torch.ops.gs_kernel import step_probe

    out = {}
    for mode in ("published", "flag"):
        step_probe(dev, 1000, mode)  # warm
        runs = [step_probe(dev, 20000, mode) for _ in range(5)]
        ns = sorted(r["ns"] for r in runs)
        out[mode] = {"ns": ns[2], "runs_ns": ns, "sms": list(runs[0]["sms"])}
    log(f"gs_sweep t_step [{card}]: {out['published']['ns']:.1f} ns a "
        f"cross-SM step (the sync-free kernel's: published value words; "
        f"median of 5 probes of 20,000 round trips, "
        f"{[round(x, 1) for x in out['published']['runs_ns']]}); the flag "
        f"design (release, acquire poll, L2 load) "
        f"{out['flag']['ns']:.1f} ns")
    return {"ns": out["published"]["ns"], "flag_ns": out["flag"]["ns"],
            "probes": out}


def sweep_library(A_host, forward, dev):
    """One PyTorch call chain that computes the w = 1, omega = 1 sweep of
    a whole level: one sparse CSR SpMV by the strictly upper (lower)
    part and one sparse triangular solve with D + L (D + U), both
    cuSPARSE.  Returns a function of (u, f), or the reason it cannot
    run."""
    M = A_host.tocsr()
    tri = sp.tril(M, 0) if forward else sp.triu(M, 0)
    rest = sp.triu(M, 1) if forward else sp.tril(M, -1)

    def csr(S):
        S = S.tocsr()
        S.sort_indices()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                torch.from_numpy(S.indptr.astype(np.int64)),
                torch.from_numpy(S.indices.astype(np.int64)),
                torch.from_numpy(S.data.astype(np.float64)),
                size=S.shape).to(dev)

    T, R = csr(tri), csr(rest)

    def sweep(u, f):
        y = (f - R @ u).unsqueeze(1)
        return torch.triangular_solve(y, T, upper=not forward).solution[:, 0]

    return sweep


def phase_gs_sweeps(amg, flush, card, label, t_step_ns):
    """Every schedule of the 96^3 f64 GS hierarchy: the sync-free form
    against its plain version in both sweep forms and bitwise the
    wavefront form (one block and grid); then each level's sweep timed
    in the wrapper's form and in the wavefront form's two variants (the
    one the wrapper picked for it is the earlier time), beside its bytes
    bound, its latency bound (wavefronts x t_step), its wavefront count,
    the plain version and the cuSPARSE pair (SpMV + triangular solve)
    for the w = 1 sweep.  Returns the V-cycle's sums (ms, earlier_ms,
    plain_ms, library_ms or None, bound_ms, latency_bound_ms), the
    largest abs error, the bitwise comparisons, one row a schedule and
    why the library did not run (or None)."""
    from hypre_tpu_torch.ops.gs_kernel import (
        ONE_BLOCK_MAX_ROWS, free_lanes, gs_sweep_cuda, gs_sweep_reference)

    rng = np.random.default_rng(13)
    vdt = amg.levels[0].dinv.dtype
    dev = amg.device
    worst, same = 0.0, 0
    rows = []
    tot = np.zeros(5)
    lib_tot, lib_why = 0.0, None
    for name, S in gs_schedules(amg):
        l = int(name.split()[0][1:])
        n, nnz = S.n, S.mat.indices.numel()
        grid = S.max_width > ONE_BLOCK_MAX_ROWS  # the wavefront form's pick
        err, k = hold_gs(S, f"{label} {name}", vdt, 1e-12, rng)
        worst, same = max(worst, err), same + k
        u, f = (torch.from_numpy(rng.standard_normal(n)).to(dev, vdt)
                for _ in range(2))
        # the CSR and divisor once, the schedule (rows, wavefront
        # pointers, hazard flags), f and u read, u written
        nbytes = (tensor_bytes(S.mat.indptr, S.mat.indices, S.mat.data,
                               S.mat.dinv, S.order, S.wf_ptr, S.hazard)
                  + 3 * n * u.element_size())
        bms, _ = bound_ms(nbytes, 2 * nnz, torch.float64)
        lat_ms = S.num_wavefronts * t_step_ns * 1e-6
        ms = time_cuda_ms(lambda: gs_sweep_cuda(S, u, f), flush, 20)
        t = {c: time_cuda_ms(lambda: gs_sweep_cuda(
            S, u, f, form="wavefront", coop=c), flush, 20) for c in (False, True)}
        slabs = S.slabs(dev)
        plain_ms = time_cuda_ms(
            lambda: gs_sweep_reference(slabs, n, u, f), flush, 3)
        lib_ms = None
        try:
            lib = sweep_library(amg._host_A[l], name.split()[1] == "fwd", dev)
            got = lib(u, f)
            want = gs_sweep_cuda(S, u, f)
            torch.cuda.synchronize()
            lrel = float((got - want).abs().max() / want.abs().max())
            require(lrel <= 1e-10, f"the cuSPARSE sweep of {name} is not "
                                   f"the kernel's: rel {lrel:.2e}")
            lib_ms = time_cuda_ms(lambda: lib(u, f), flush, 10)
        except RuntimeError as e:  # the yardstick only: say why
            if "cuSPARSE sweep" in str(e):
                raise
            lib_why = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        del slabs
        tot += (ms, t[grid], plain_ms, bms, lat_ms)
        if lib_ms is not None:
            lib_tot += lib_ms
        lanes = free_lanes(S.max_row)
        rows.append({"schedule": name, "rows": n, "nnz": nnz,
                     "wavefronts": S.num_wavefronts, "widest": S.max_width,
                     "lanes": lanes, "ms": ms,
                     "earlier_ms": t[grid], "one_block_ms": t[False],
                     "grid_ms": t[True], "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bms,
                     "latency_bound_ms": lat_ms, "bytes": nbytes})
        log(f"gs_sweep [{label} {name}: {n} rows, {nnz} entries, "
            f"{S.num_wavefronts} wavefronts, widest {S.max_width}; {card}]: "
            f"sync-free ({lanes} lanes) {ms * 1e3:.1f} us, "
            f"{ms * 1e3 / S.num_wavefronts:.2f} us a wavefront; the "
            f"wavefront form one block {t[False] * 1e3:.1f} us, grid "
            f"{t[True] * 1e3:.1f} us (earlier: the "
            f"{'grid' if grid else 'block'}); plain {plain_ms * 1e3:.0f} us; "
            f"cuSPARSE SpMV + triangular solve "
            + (f"{lib_ms * 1e3:.1f} us" if lib_ms is not None
               else f"did not run ({lib_why})")
            + f"; bytes bound {bms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB), "
            f"latency bound {lat_ms * 1e3:.1f} us")
    torch.cuda.empty_cache()
    require_no_gs_fault(dev, f"gs_sweep timing [{label}]")
    lib_sum = lib_tot if all(r["library_ms"] is not None for r in rows) else None
    log(f"gs_sweep [{label}] one V-cycle's {len(rows)} sweeps: kernel "
        f"{tot[0]:.3f} ms (the wavefront form, as the wrapper picked it "
        f"before: {tot[1]:.3f} ms), plain {tot[2]:.1f} ms, cuSPARSE "
        + (f"{lib_sum:.3f} ms" if lib_sum is not None
           else f"did not run on every level ({lib_why})")
        + f", bytes bound {tot[3]:.4f} ms, latency bound {tot[4]:.3f} ms "
        f"({sum(r['wavefronts'] for r in rows)} wavefronts x "
        f"{t_step_ns:.1f} ns); max abs err {worst:.2e}, {same} sweeps "
        f"bitwise the wavefront form")
    return ((tot[0], tot[1], tot[2], lib_sum, tot[3], tot[4]), worst, same,
            rows, lib_why)


def phase_gs_masked(dev, card):
    """The C / F halves of the CF-ordered sweeps (relax_order 1) on every
    level of the 24^3 f64 hierarchy, and a nonsymmetric matrix whose
    wavefronts read same-wavefront neighbours (the wavefront form's
    two-phase wavefronts): the sync-free form against its plain version
    and bitwise the wavefront form in both grid variants."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops import CSRMatrix
    from hypre_tpu_torch.solvers.amg import BoomerAMG
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    rng = np.random.default_rng(17)
    amg = BoomerAMG(laplacian_7pt(24, 24, 24),
                    slice_options(dtype="float64", relax_down=13, relax_up=14,
                                  relax_order=1), device=dev)
    scheds = gs_schedules(amg)
    require(scheds and all(" C" in s or " F" in s for s, _ in scheds),
            "relax_order 1 built no C / F halves")
    held = [hold_gs(S, f"24^3 CF {name}", torch.float64, 1e-12, rng)
            for name, S in scheds]
    worst = max(e for e, _ in held)
    same = sum(k for _, k in held)
    n = 20000
    B = sp.random(n, n, 4.0 / n, random_state=np.random.default_rng(5),
                  format="csr")
    M = (B + sp.diags(8.0 + rng.random(n))).tocsr()
    M.sort_indices()
    hazards = []
    for forward in (True, False):
        S = build_gs_schedule(CSRMatrix.from_scipy(M), forward, device=dev)
        hazards.append(int(S.hazard.sum()))
        require(S.any_hazard, "the nonsymmetric matrix has no wavefront that "
                              "reads itself")
        for vdt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            worst_ns, k = hold_gs(S, f"nonsymmetric "
                                     f"{'fwd' if forward else 'bwd'} {vdt}",
                                  vdt, tol, rng)
            same += k
            if vdt == torch.float64:
                worst = max(worst, worst_ns)
    log(f"gs_sweep C / F halves ({len(scheds)} schedules at 24^3) and a "
        f"nonsymmetric {n}-row matrix ({hazards} hazard wavefronts fwd / "
        f"bwd), f64 and f32 [{card}]: the sync-free form agrees with the "
        f"plain version, max abs err {worst:.2e}, and is the wavefront "
        f"form's bits in both grid variants ({same} sweeps)")
    return {"schedules": len(scheds), "hazard_wavefronts": hazards,
            "max_abs_err": worst, "bitwise_wavefront": same}


def run_gs(nx, opts, dev, card, label, want_its):
    """One GS solve at nx^3 through run_slice, the counts set to 0 just
    before and read just after: the JAX package's iteration count, a
    right solution, launches exactly as the hierarchy says (gs_sweep
    one a level and direction of a V-cycle); then one more solve under
    torch.profiler.  Prints the levels, the setup phases and the
    schedules' seconds and bytes.  Returns (amg, numbers)."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda
    from hypre_tpu_torch.profile_slice import profile_solve
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(nx, opts, dev)
    counts = read_counts()
    syncfree = gs_sweep_cuda.syncfree_launches
    require_no_gs_fault(dev, f"GS {label} solve")
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in (
        "SETUP", "STRENGTH", "COARSEN", "INTERP", "RAP", "FREEZE",
        "GS_SCHEDULE")}
    rel, bound = check_solution(amg, res, nx**3)
    its = res.num_iterations
    expected = expected_launches(amg, its)
    per_cycle = amg.cycle_launches()
    _, wall, busy_us, events, _ = profile_solve(make_solve(amg), cpu=False)
    # "gs_sweep_" covers both forms' kernels
    gs_us = sum(e.time_range.end - e.time_range.start for e in events
                if "gs_sweep_" in e.name)
    require_no_gs_fault(dev, f"GS {label} profiled solve")
    nbytes = gs_bytes(amg)
    for line in level_lines(amg):
        log(f"GS [{label}] levels: {line}")
    log(f"GS [{label} {nx}^3; {card}]: {its} iterations (JAX package: "
        f"{want_its}), final rel residual {float(res.rel_residual_norm):.3e} "
        f"(true, in f64: {rel:.3e}, bound {bound:.1e}); setup {setup_s:.2f} "
        f"s (phases {phases}; the GS schedules {phases['GS_SCHEDULE']:.3f} s, "
        f"{nbytes / 1e6:.1f} MB on the card); solve {solve_s * 1e3:.2f} ms; "
        f"under the profiler wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle {100 * (1 - busy_us / 1e6 / wall):.1f}"
        f"%), gs_sweep {gs_us / 1e3:.2f} ms of it, {len(events)} device "
        f"events ({len(events) / max(its, 1):.0f} an iteration); per V-cycle "
        f"{per_cycle}; launches {counts}, {syncfree} of the gs_sweep ones "
        f"in the sync-free form")
    require(res.converged and its == want_its,
            f"GS {label}: {its} iterations, the JAX package's {want_its}")
    require(counts == expected and counts["gs_sweep"] > 0,
            f"GS {label}: launches {counts} are not the hierarchy's "
            f"{expected}")
    require(syncfree == counts["gs_sweep"],
            f"GS {label}: {syncfree} of {counts['gs_sweep']} sweeps in the "
            f"sync-free form, the default on every level")
    return amg, {"iterations": its, "setup_s": setup_s, "solve_s": solve_s,
                 "busy_ms": busy_us / 1e3, "wall_ms": wall * 1e3,
                 "gs_sweep_ms": gs_us / 1e3,
                 "kernels_per_iteration": len(events) / max(its, 1),
                 "phases": phases, "schedule_bytes": nbytes,
                 "per_cycle": per_cycle, "launches": counts,
                 "syncfree_launches": syncfree}


def card_vs_cpu(nx, opts, dev, label, want_its, want_gates=None, A=None):
    """The nx^3 solve (of the Poisson problem, or of the matrix A) on the
    card (counts at 0 before, read after: as the hierarchy says) and on
    the CPU: both the JAX package's count, the final relative residuals
    within 1e-10 of each other, x within 1e-9.  want_gates: {key:
    value} of `gates` both hierarchies must show (the JAX package's
    decisions)."""
    zero_counts()
    amg_g, res_g, _, solve_s = run_slice(nx, opts, dev, A)
    counts = read_counts()
    require_no_gs_fault(dev, f"{label} card solve")
    expected = expected_launches(amg_g, res_g.num_iterations)
    amg_c, res_c, _, cpu_s = run_slice(nx, opts, "cpu", A)
    got_gates = None
    if want_gates is not None:
        got_gates = [{k: gates(a)[k] for k in want_gates}
                     for a in (amg_g, amg_c)]
        log(f"{label} {nx}^3 gates: card {got_gates[0]}, CPU "
            f"{got_gates[1]} (JAX package: {want_gates})")
        require(got_gates[0] == got_gates[1] == want_gates,
                f"{label}: gates {got_gates}, the JAX package's {want_gates}")
    rg, rc = float(res_g.rel_residual_norm), float(res_c.rel_residual_norm)
    dx = float((res_g.x.cpu() - res_c.x).abs().max() / res_c.x.abs().max())
    log(f"{label} {nx}^3 card vs CPU: iterations {res_g.num_iterations} vs "
        f"{res_c.num_iterations} (JAX package: {want_its}); rel residual "
        f"{rg:.10e} vs {rc:.10e} (rel diff {abs(rg - rc) / rc:.2e}); max rel "
        f"diff of x {dx:.2e}; card solve {solve_s * 1e3:.1f} ms, CPU "
        f"{cpu_s:.2f} s; launches {counts}")
    require(res_g.num_iterations == res_c.num_iterations == want_its,
            f"{label}: iterations {res_g.num_iterations} (card), "
            f"{res_c.num_iterations} (CPU), JAX {want_its}")
    require(abs(rg - rc) <= 1e-10 * rc and dx <= 1e-9,
            f"{label}: the card's solve differs from the CPU's")
    require(counts == expected, f"{label}: launches {counts} are not the "
                                f"hierarchy's {expected}")
    out = {"iterations": res_g.num_iterations, "rel_residual_norm": rg,
           "cpu_rel_residual_norm": rc, "solve_s": solve_s,
           "launches": counts}
    if got_gates is not None:
        out["gates"] = got_gates[0]
    return out


# -- 12. the cycle options and the coarsening family -------------------------

# the JAX package's PCG counts on the CPU at 96^3 (the bench protocol: b =
# ones, two-norm, tol 1e-6; the plain forms, f64 unless marked), recomputed
# by `python -m pytest -m slow tests/test_torch_cycles.py -k chip_pin`
# (~1 min each on a CPU).  {label: (options beyond slice_options(), count,
# slack)}; f32/bf16 within one, as PRODUCTION_F32
F32_BF16 = dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02)
CF_SWEEPS = ((1, -1), (1, -1), (-1, 1), (0,))  # C then F down, F then C up
CYCLES96 = {
    "W f64": (dict(cycle_type=2), 14, 0),
    "W f32/bf16": (dict(cycle_type=2, **F32_BF16), 14, 1),
    "F f64": (dict(fcycle=True), 13, 0),
    "additive=0": (dict(additive=0), 59, 0),
    "mult_additive=0": (dict(mult_additive=0), 25, 0),
    "simple=0": (dict(simple=0), 33, 0),
    "grid_relax_points C/F l1-Jacobi": (dict(
        grid_relax_type=(18, 18, 18, 9), grid_relax_points=CF_SWEEPS), 24, 0),
    "grid_relax_type (13, 13, 14, 9)": (dict(
        grid_relax_type=(13, 13, 14, 9)), 17, 0),
    "hmis": (dict(coarsen_type="hmis"), 12, 0),
    "rs": (dict(coarsen_type="rs"), 12, 0),
}
# the W-cycle on the lattice forms: the plain W count.  The lattice forms
# are exact re-layouts of the same hierarchy (the device RAP's level 1
# differs by rounding); the JAX package's 96^3 lattice build needs ~50 GB
# of host memory, so its count is held at 24^3 instead
# (tests/test_torch_cycles.py::test_lattice_cycles_match_jax)
W96_LATTICE = 14
# the JAX package's counts at 24^3 (PCG as above; SolveT: the stationary
# transpose solve of difconv_7pt(24, 24, 24, ax=6, ay=3, az=1), tol 1e-8)
CYCLES24 = {
    "cljp": (dict(coarsen_type="cljp"), 8),
    "falgout": (dict(coarsen_type="falgout"), 9),
    "cgc": (dict(coarsen_type="cgc"), 9),
    "cr": (dict(coarsen_type="cr"), 13),
    "strength_abs": (dict(strength_abs=True), 15),
    "seq_threshold=150": (dict(seq_threshold=150), 16),
}
SOLVET24 = 54
CYCLE_PHASES = ("SETUP", "STRENGTH", "COARSEN", "INTERP", "RAP", "FREEZE",
                "GS_SCHEDULE", "DEVICE_RAP", "COLLAPSE")


def statistics(amg) -> dict:
    """par_stats.c's numbers of a hierarchy."""
    return {"num_levels": amg.num_levels,
            "num_frozen_levels": amg.num_frozen_levels,
            "grid_complexity": amg.grid_complexity(),
            "operator_complexity": amg.operator_complexity(),
            "cycle_complexity": amg.cycle_complexity()}


# warm solves timed for a median: 5 keep the whole script well inside
# its 1,200 s
MEDIAN_REPS = 3  # 5 until phase 19 came


def solve_median_ms(solve, reps: int = MEDIAN_REPS):
    """(median, min, max) ms of `reps` warm solves, CUDA events around
    each."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        solve()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def busy(solve, its: int = 1, cpu: bool = False) -> dict:
    """One solve() under torch.profiler: its wall time, device busy,
    idle share and device events an iteration.  The device activity
    alone is recorded unless cpu (the profiler collects it several times
    faster; every number here reads device events); phases 6-16 recorded
    the host's activity too until phase 20 came."""
    from hypre_tpu_torch.profile_slice import profile_solve

    _, wall, busy_us, events, _ = profile_solve(solve, cpu)
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3,
            "idle_share": 1 - busy_us / 1e6 / wall,
            "kernels_per_iteration": len(events) / max(its, 1)}


def run_cycle(opts, dev, card, label, want, slack, A=None):
    """One 96^3 run of a cycle option through run_slice (on the Poisson
    problem, or on the matrix A), the counts set to 0 just before and
    read just after: the JAX package's count, a right solution, launches
    exactly `cycle_launches` x the cycles plus PCG's matvecs; then the
    statistics, the setup by phase, the solve's median of 3 and one
    profiled solve.  Returns (amg, numbers)."""
    from hypre_tpu_torch.profile_slice import profile_solve
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(NX, opts, dev, A)
    counts = read_counts()
    require_no_gs_fault(dev, f"cycles {label} solve")
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in CYCLE_PHASES
              if GLOBAL_TIMER.seconds(k)}
    rel, bound = check_solution(amg, res, amg.levels[0].dinv.shape[0])
    its = res.num_iterations
    expected = expected_launches(amg, its)
    per_cycle = {k: v for k, v in amg.cycle_launches().items() if v}
    solve = make_solve(amg)
    med, lo, hi = solve_median_ms(solve)
    _, wall, busy_us, events, _ = profile_solve(solve, cpu=False)
    require_no_gs_fault(dev, f"cycles {label} timed solves")
    stats = statistics(amg)
    log(f"cycles [{label} {NX}^3; {card}]: {its} iterations (JAX package: "
        f"{want}{f' +- {slack}' if slack else ''}), final rel residual "
        f"{float(res.rel_residual_norm):.3e} (true, in f64: {rel:.3e}, bound "
        f"{bound:.1e}); statistics {stats}; setup {setup_s:.2f} s (phases "
        f"{phases}); solve median of {MEDIAN_REPS} {med:.2f} ms ({lo:.2f}-{hi:.2f}); "
        f"under the profiler wall {wall * 1e3:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle {100 * (1 - busy_us / 1e6 / wall):.1f}"
        f"%), {len(events)} device events ({len(events) / max(its, 1):.0f} "
        f"an iteration); per cycle {per_cycle}; launches {counts}")
    require(res.converged and abs(its - want) <= slack,
            f"cycles {label}: {its} iterations, the JAX package's {want}")
    require(counts == expected,
            f"cycles {label}: launches {counts} are not the hierarchy's "
            f"{expected}")
    return amg, {"iterations": its, "statistics": stats, "setup_s": setup_s,
                 "phases": phases, "solve_median_ms": med,
                 "solve_min_max_ms": [lo, hi], "busy_ms": busy_us / 1e3,
                 "wall_ms": wall * 1e3,
                 "kernels_per_iteration": len(events) / max(its, 1),
                 "per_cycle": per_cycle, "launches": counts}


def stationary_card_vs_cpu(dev, label, want, opts, transpose: bool,
                           max_iter: int = 60, hold: bool = False):
    """The stationary solve (Solve, or SolveT with transpose) at 24^3 on
    the nonsymmetric convection-diffusion operator, card against CPU:
    the JAX package's count on both; the residual histories within
    1e-10 relative while above 1e-4 of the first and within 1e-14 of
    the first everywhere (a stationary solve's b - A x cancels as it
    converges: the final 9e-9 differs in its 9th digit between the
    card's FMAs and the CPU); the card's launches exactly its
    iterations x `cycle_launches(levels, from_zero=False)` plus a
    fine-level residual each and one more.  hold: every operator of
    the card's hierarchy against its plain version after the solve
    (`phase_hold_operators`, 1e-12)."""
    from hypre_tpu_torch.models import difconv_7pt
    from hypre_tpu_torch.ops.dia import kernel_launches
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    A = difconv_7pt(24, 24, 24, ax=6.0, ay=3.0, az=1.0)
    out, held = {}, None
    for where in (dev, torch.device("cpu")):
        amg = BoomerAMG(A, opts, device=where)
        # the transposed hierarchy is frozen before the counts start
        levels = amg.levels_T if transpose else amg.levels
        b = torch.ones(24**3, dtype=torch.float64, device=where)
        zero_counts()
        res = (amg.solveT if transpose else amg.solve)(b, tol=1e-8,
                                                         max_iter=max_iter)
        counts = read_counts()
        if hold and where.type == "cuda":
            held = phase_hold_operators(amg, 1e-12, label)
        its = res.num_iterations
        want_l = {k: 0 for k in counts}
        for k, v in amg.cycle_launches(levels, from_zero=False).items():
            want_l[k] += its * v
        for k, v in kernel_launches(levels[0].A).items():
            want_l[k] += (its + 1) * v
        out[where.type] = (res, counts, want_l)
    (rg, cg, wg), (rc, _, _) = out["cuda"], out["cpu"]
    a, b_ = float(rg.rel_residual_norm), float(rc.rel_residual_norm)
    hg, hc = rg.res_norms.cpu().numpy(), rc.res_norms.numpy()
    ok = ~np.isnan(hc)
    early = ok & (hc >= 1e-4 * hc[0])
    early_rel = float(np.max(np.abs(hg[early] - hc[early]) / hc[early]))
    late_abs = float(np.max(np.abs(hg[ok] - hc[ok])) / hc[0])
    log(f"{label} 24^3 card vs CPU: iterations {rg.num_iterations} vs "
        f"{rc.num_iterations} (JAX package: {want}); rel residual {a:.10e} "
        f"vs {b_:.10e}; histories: {early_rel:.2e} relative above 1e-4 of "
        f"the first, {late_abs:.2e} of the first everywhere; launches {cg}")
    require(rg.num_iterations == rc.num_iterations == want and rg.converged,
            f"{label}: iterations {rg.num_iterations} (card), "
            f"{rc.num_iterations} (CPU), JAX {want}")
    require(np.array_equal(np.isnan(hg), np.isnan(hc)) and early_rel <= 1e-10
            and late_abs <= 1e-14, f"{label}: the card's residual history "
                                   f"differs from the CPU's")
    require(cg == wg, f"{label}: launches {cg} are not {wg}")
    out = {"iterations": rg.num_iterations, "rel_residual_norm": a,
           "cpu_rel_residual_norm": b_, "launches": cg}
    if held is not None:
        out["held"] = held
    return out


def phase_cycles(dev, card):
    """12. The cycle options (W, F, the additive family, the grid_relax
    arrays) and the coarsening family at 96^3 (`run_cycle`), the
    W-cycle also on the lattice forms with every operator of that
    hierarchy held (`phase_hold_operators`); at 24^3 CLJP, Falgout,
    CGC, CR, strength_abs, seq_threshold and SolveT card against CPU.
    Returns ({label: numbers} at 96^3, {label: numbers} at 24^3)."""
    out = {}
    for label, (kw, want, slack) in CYCLES96.items():
        amg, out[label] = run_cycle(slice_options(**{"dtype": "float64", **kw}),
                                    dev, card, label, want, slack)
        del amg
        torch.cuda.empty_cache()
    label = "W lattice f64"
    amg, out[label] = run_cycle(lattice_options(NX, dtype="float64",
                                                cycle_type=2),
                                dev, card, label, W96_LATTICE, 0)
    g = gates(amg)
    log(f"cycles [{label}] gates {g}")
    require(g["embed_level1"] and g["relocated_levels"] and not g["collapsed"],
            f"{label}: the lattice forms did not engage as expected ({g})")
    out[label]["gates"] = g
    out[label]["held"] = phase_hold_operators(amg, 1e-12, label)
    del amg
    torch.cuda.empty_cache()
    small = {label: card_vs_cpu(24, slice_options(dtype="float64", **kw), dev,
                                label, want)
             for label, (kw, want) in CYCLES24.items()}
    small["solveT"] = stationary_card_vs_cpu(
        dev, "solveT", SOLVET24, slice_options(dtype="float64"), True)
    return out, small


# -- 13. aggressive coarsening, the interpolation family, AIR ----------------

# the JAX package's PCG counts at 96^3 on the plain forms (the bench
# protocol: b = ones, two-norm, tol 1e-6) with ext+i, P_max_elmts 4 and
# one aggressive level, recomputed by `python -m pytest -m slow
# tests/test_torch_agg.py -k chip_pin` (~1 min each on a CPU).  {label:
# (options beyond slice_options("ext+i"), count, slack)}
AGG96 = {
    "(a) multipass f64": (dict(agg_num_levels=1), 23, 0),
    "(b) multipass f32/bf16": (dict(agg_num_levels=1, **F32_BF16), 27, 1),
    "(c) two-stage f64": (dict(agg_num_levels=1, agg_interp_type=1), 20, 0),
    # MFEM's HypreBoomerAMG CPU defaults: HMIS, agg 1, ext+i, P_max 4,
    # relax 8
    "(d) MFEM default f64": (dict(coarsen_type="hmis", agg_num_levels=1,
                                  relax_down=8, relax_up=8), 11, 0),
}
# the JAX package's counts at 24^3 (PCG as above; slice_options(), so
# classical interpolation where none is named)
INTERP24 = {
    "standard": (dict(interp_type="standard"), 11),
    "standard-sep": (dict(interp_type="standard-sep"), 11),
    "ff": (dict(interp_type="ff"), 12),
    "ff1": (dict(interp_type="ff1"), 12),
    "ext": (dict(interp_type="ext"), 12),
    "direct": (dict(interp_type="direct"), 16),
    "multipass": (dict(interp_type="multipass"), 16),
    "post_interp_type=1": (dict(post_interp_type=1), 11),
    "agg num_paths=2 agg_P_max_elmts=4": (dict(
        interp_type="ext+i", agg_num_levels=1, num_paths=2,
        agg_P_max_elmts=4), 18),
}
# one aggressive level on the lattice defaults at 24^3: (options beyond
# lattice_options(24), count, the JAX package's gates).  The embedding
# declines the multipass level 1 (547 embedded offsets, above
# max_embedded_offsets 512); the sub-cycle below level 1 collapses
AGG_LATTICE24 = (dict(interp_type="ext+i", agg_num_levels=1), 19,
                 {"embed_level1": False, "relocated_levels": [],
                  "collapsed": True, "setup_levels": 5})
# AIR on difconv_7pt(24, 24, 24, ax=6, ay=3, az=1) through BoomerAMG.solve
# (b = ones, tol 1e-8, at most 80 cycles) on the plain forms with the
# JAX package's AIR smoother (weighted Jacobi, 0.7): {label: (options,
# count, transpose)}, the JAX package's counts
AIR24_OPTIONS = dict(dtype="float64", relax_down=0, relax_up=0,
                     relax_weight=0.7)
AIR24 = {
    "restrict_type=1": (dict(restrict_type=1), 56, False),
    "restrict_type=2": (dict(restrict_type=2), 29, False),
    "restrict_type=2 air_neumann_degree=2": (dict(
        restrict_type=2, air_neumann_degree=2), 34, False),
    "solveT restrict_type=1": (dict(restrict_type=1), 62, True),
}


def phase_agg(dev, card):
    """13. Aggressive coarsening at 96^3 (`run_cycle`): multipass in f64
    and f32/bf16/ngt 0.02, two-stage, and MFEM's default (HMIS + relax
    8), every operator of the f64 multipass hierarchy held against its
    plain version; at 24^3 card against CPU the seven interpolations
    beyond classical and ext+i, Jacobi post-interpolation, num_paths 2
    with agg_P_max_elmts 4, and one aggressive level on the lattice
    defaults with the JAX package's gates; AIR (restrict_type 1, 2, 2
    with a Neumann degree 2, and SolveT with 1) through the stationary
    solve, each Solve hierarchy's operators held.  Returns ({label:
    numbers} at 96^3, {label: numbers} at 24^3, {label: numbers} of
    AIR)."""
    out = {}
    for label, (kw, want, slack) in AGG96.items():
        amg, out[label] = run_cycle(
            slice_options("ext+i", **{"dtype": "float64", **kw}), dev, card,
            label, want, slack)
        out[label]["levels"] = [a.shape[0] for a in amg._host_A]
        if label.startswith("(a)"):
            out[label]["held"] = phase_hold_operators(amg, 1e-12, label)
        del amg
        torch.cuda.empty_cache()
    small = {label: card_vs_cpu(24, slice_options(dtype="float64", **kw), dev,
                                label, want)
             for label, (kw, want) in INTERP24.items()}
    kw, want, want_gates = AGG_LATTICE24
    small["agg lattice defaults"] = card_vs_cpu(
        24, lattice_options(24, dtype="float64", **kw), dev,
        "agg lattice defaults", want, want_gates)
    air = {label: stationary_card_vs_cpu(
        dev, f"AIR {label}", want,
        slice_options(**AIR24_OPTIONS, **kw), transpose, max_iter=80,
        hold=not transpose)
        for label, (kw, want, transpose) in AIR24.items()}
    return out, small, air


# -- 14. systems / nodal / GSMG BoomerAMG, the Krylov family, LOBPCG --------

# the hypre oracle's systems protocol (tests/test_systems_amg.py:87-113):
# two functions, interleaved, max_row_sum 1.0 (the ij driver's default)
SYS = dict(num_functions=2, max_row_sum=1.0)
# The JAX package's counts on the CPU at 96^3 (b = ones, tol 1e-6, PCG
# with the two-norm test, the plain forms, f64 unless marked), recomputed
# by `python -m pytest -m slow tests/test_torch_systems.py -k chip_pin`
# (~1 min each on a CPU; (a)-(c) need ~30 GB of host memory there).
# {label: (problem, options beyond slice_options(), count, slack)};
# "sys" is sys_laplacian_7pt(96, 96, 96, 2), 1,769,472 rows.  (c) has no
# non-Galerkin filter: with nongalerkin_tol 0.02 both packages' systems
# setups blow up (level-2 entries of 1e33 at 24^3 x 2, a coarse pinv that
# does not converge at 96^3 x 2; tests/test_torch_systems.py pins it).
# (d) interpolates ext+i: classical interpolation on the GSMG graph gives
# NaN on level 2 at 96^3 in both packages.  (c) is held to the port's own
# count on the CPU, 45 (the f64 count): the JAX package's is
# SYS96_F32_JAX.  The hierarchy is the same bits; the f32 histories agree
# to 4 digits until ~3e-5 of the first residual (1e-4 at 48^3 x 2, where
# the counts are 26 and 27), below which f32 rounding sets the count
# (the true residual ends at ~2e-4)
SYS96_F32_JAX = 50
SYS96 = {
    "(a) nodal 1 f64": ("sys", dict(nodal=1, **SYS), 45, 0),
    "(b) unknown ext+i f64": ("sys", dict(interp_type="ext+i", **SYS), 21, 0),
    "(c) nodal 1 f32/bf16": ("sys", dict(nodal=1, dtype="float32",
                                         mat_dtype="bfloat16", **SYS),
                             45, 1),
    "(d) gsmg ext+i f64": ("laplacian", dict(gsmg=1, interp_type="ext+i"),
                           29, 0),
}
# (e) difconv_7pt(96, 96, 96) with slice_options("ext+i") (`ij -difconv
# -solver 3`'s setup), one hierarchy, each solver from b = ones to tol
# 1e-6: {label: (solver, options), the JAX package's count}
KRYLOV96 = {
    "gmres": (("gmres", dict(k_dim=5)), 14),
    "flexgmres": (("flexgmres", dict(k_dim=5)), 14),
    "lgmres": (("lgmres", dict(k_dim=10)), 14),
    "cogmres cgs 1": (("cogmres", dict(k_dim=5, cgs=1)), 14),
    "cogmres cgs 2": (("cogmres", dict(k_dim=5, cgs=2)), 14),
    "bicgstab": (("bicgstab", dict()), 8),
}
# (f) LOBPCG on laplacian_7pt(96^3), m 4, the slice's V-cycle as T column
# by column, tol 1e-6, X0 standard normal from seed 2026
LOBPCG_M, LOBPCG_SEED = 4, 2026
LOBPCG96 = 38
# at 24^3, card against CPU, the JAX package's counts (PCG as above)
SYS24 = {
    **{f"nodal {k} diag {d}": ("sys", dict(nodal=k, nodal_diag=d, **SYS), w)
       for k, w in ((1, 17), (2, 17), (3, 16), (4, 17), (6, 16))
       for d in (0, 1)},
    # the unknowns function-major (not interleaved), dof_func saying so
    "user dof_func ext+i": ("sys function-major",
                            dict(interp_type="ext+i", **SYS), 17),
    "gsmg num_samples 3": ("sys", dict(gsmg=1, num_samples=3, **SYS), 24),
}
# the offset budgets on the lattice defaults at 24^3 (relocate_min_n2=0,
# levels 2 and 3 relocated): (options beyond lattice_options(24), count,
# the JAX package's gates).  No relocated A is above the dense threshold
# at 24^3, so relocate_offset_budget only passes through the plan there
BUDGET24 = {
    "transfer_offset_budget 8": (dict(transfer_offset_budget=8), 18),
    "transfer 8, relocate 16 strong": (dict(
        transfer_offset_budget=8, relocate_offset_budget=16,
        relocate_lump="strong"), 18),
}
BUDGET24_GATES = {"embed_level1": True, "relocated_levels": [2, 3],
                  "collapsed": True, "setup_levels": 6}
# CGNR (`ij -solver 5 / 6`) on difconv_7pt(24^3), max_iter 50: neither
# preconditioner converges in the JAX package either, so the card is held
# to its count and to the CPU's history
CGNR24 = {"amg": 50, "diag": 50}
LOBPCG24 = 28


def problem_matrix(kind: str, nx: int):
    """(CSR matrix, dof_func or None) of a phase-14 problem."""
    from hypre_tpu_torch.models import (difconv_7pt, laplacian_7pt,
                                        sys_laplacian_7pt)
    from hypre_tpu_torch.ops.csr import CSRMatrix

    if kind == "laplacian":
        return laplacian_7pt(nx, nx, nx), None
    if kind == "difconv":
        return difconv_7pt(nx, nx, nx), None
    A = sys_laplacian_7pt(nx, nx, nx, 2)
    if kind == "sys":
        return A, None
    n = A.shape[0]
    perm = np.argsort(np.arange(n) % 2, kind="stable")  # function-major
    Ap = A.to_scipy()[perm][:, perm].tocsr()
    Ap.sort_indices()
    return CSRMatrix.from_scipy(Ap), (np.arange(n) % 2)[perm]


def predicted_calls(name: str, kw: dict, its: int) -> dict:
    """The operator applications a solve of `its` iterations makes, from
    the solver's loop alone: {"A": matvecs, "M": preconditioner
    applications, "AT": transpose matvecs}.  The restarted solvers run
    full cycles of k_dim steps but the last; LGMRES's cycle c takes
    k_dim - min(c, aug_dim) Krylov steps (the others apply no operator)
    and stores an augmentation pair (A M z) after every cycle but the
    last; BiCGSTAB checks the true residual once, at convergence; PCG
    (no two-norm test) applies M to b for the norm, to the first r and
    once an iteration."""
    if name == "pcg":
        return {"A": 1 + its, "M": 2 + its, "AT": 0}
    if name in ("gmres", "flexgmres", "cogmres", "lgmres"):
        kd = kw["k_dim"]
        cycles = -(-its // kd)
        if name == "lgmres":
            ad = kw.get("aug_dim", 2)
            last = its - kd * (cycles - 1)
            kry = sum(kd - min(c, ad) for c in range(cycles - 1)) + min(
                last, kd - min(cycles - 1, ad))
            return {"A": 1 + kry + cycles + cycles - 1,
                    "M": kry + cycles + cycles - 1, "AT": 0}
        steps_M = its if name == "flexgmres" else its + cycles
        return {"A": 1 + its + cycles, "M": steps_M, "AT": 0}
    if name == "bicgstab":
        return {"A": 2 + 2 * its, "M": 2 * its, "AT": 0}
    if name == "cgnr":
        return {"A": 1 + its, "M": 1 + its, "AT": 1 + its}
    raise ValueError(name)


def krylov_solve(amg, name, kw, b, A0, AT0=None, precond="amg"):
    """solve() -> result: the named solver on A0 (a frozen operator) with
    the hierarchy's V-cycle (or the diagonal of A0) as M, tol 1e-6,
    max_iter 200 (CGNR 50); `calls` counts each operator's
    applications."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers import krylov

    calls = {"A": 0, "M": 0, "AT": 0}
    dinv = amg.levels[0].dinv

    def op(key, fn):
        def apply(x):
            calls[key] += 1
            return fn(x)
        return apply

    A = op("A", lambda x: spmv(A0, x))
    M = op("M", amg.precond if precond == "amg" else lambda r: dinv * r)
    opts_cls = {"gmres": "GMRESOptions", "flexgmres": "FlexGMRESOptions",
                "lgmres": "LGMRESOptions", "cogmres": "COGMRESOptions",
                "bicgstab": "BiCGSTABOptions", "cgnr": "CGNROptions"}[name]
    opts = getattr(krylov, opts_cls)(
        tol=1e-6, max_iter=50 if name == "cgnr" else 200, **kw)
    fn = getattr(krylov, name)
    if name == "cgnr":
        AT = op("AT", lambda x: spmv(AT0, x))
        return (lambda: fn(A, AT, b, M=M, opts=opts)), calls
    return (lambda: fn(A, b, M=M, opts=opts)), calls


def krylov_launches(amg, calls: dict, A0, AT0=None, precond="amg") -> dict:
    """Kernel launches of a Krylov solve's operator applications: each
    matvec what `kernel_launches` says of its operator, each V-cycle
    what `cycle_launches` says (the diagonal launches nothing)."""
    from hypre_tpu_torch.ops.dia import kernel_launches

    out = {name: 0 for name in read_counts()}
    parts = [(A0, calls["A"])]
    if AT0 is not None:
        parts.append((AT0, calls["AT"]))
    for op, k in parts:
        for name, c in kernel_launches(op).items():
            out[name] += k * c
    if precond == "amg":
        for name, c in amg.cycle_launches().items():
            out[name] += calls["M"] * c
    return out


def run_krylov(amg, label, name, kw, want, card, A0):
    """One Krylov solve at 96^3 over a built hierarchy, the counts set to 0
    just before and read just after: the JAX package's count, a right
    solution (the true residual in f64), the operator applications the
    solver's loop predicts and exactly their launches; then the solve's
    median of 3 and one profiled solve.  Returns the numbers."""
    from hypre_tpu_torch.profile_slice import profile_solve

    b = torch.ones_like(amg.levels[0].dinv)
    solve, calls = krylov_solve(amg, name, kw, b, A0)
    zero_counts()
    res = solve()
    torch.cuda.synchronize()
    counts = read_counts()
    its = res.num_iterations
    made = dict(calls)
    rel, bound = check_solution(amg, res, b.shape[0])
    want_calls = predicted_calls(name, kw, its)
    expected = krylov_launches(amg, made, A0)
    med, lo, hi = solve_median_ms(solve)
    _, wall, busy_us, events, _ = profile_solve(solve, cpu=False)
    log(f"krylov [{label} 96^3; {card}]: {its} iterations (JAX package: "
        f"{want}), final rel residual {float(res.rel_residual_norm):.3e} "
        f"(true, in f64: {rel:.3e}, bound {bound:.1e}); applications {made} "
        f"(predicted {want_calls}); solve median of {MEDIAN_REPS} {med:.2f} ms "
        f"({lo:.2f}-{hi:.2f}); under the profiler wall {wall * 1e3:.2f} ms, "
        f"device busy {busy_us / 1e3:.2f} ms (idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.1f}%), {len(events)} device "
        f"events ({len(events) / max(its, 1):.0f} an iteration); launches "
        f"{counts}")
    require(res.converged and its == want,
            f"krylov {label}: {its} iterations, the JAX package's {want}")
    require(made == want_calls, f"krylov {label}: applications {made}, the "
                                f"solver's loop predicts {want_calls}")
    require(counts == expected, f"krylov {label}: launches {counts} are not "
                                f"the applications' {expected}")
    return {"iterations": its, "rel_residual_norm":
            float(res.rel_residual_norm), "true_rel_residual": rel,
            "applications": made, "solve_median_ms": med,
            "solve_min_max_ms": [lo, hi], "busy_ms": busy_us / 1e3,
            "wall_ms": wall * 1e3,
            "kernels_per_iteration": len(events) / max(its, 1),
            "launches": counts}


def lobpcg_run(amg, X0):
    """LOBPCG (tol 1e-6, at most 100 iterations) over a hierarchy's fine
    operator with its V-cycle as T, column by column; returns (result,
    {"A": columns, "T": columns})."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.eigen import LOBPCGOptions, lobpcg

    calls = {"A": 0, "T": 0}
    A0, cycle = amg.levels[0].A, amg.precond

    def columns(key, fn):
        def apply(X):
            calls[key] += X.shape[1]
            return torch.stack([fn(X[:, k].contiguous())
                                for k in range(X.shape[1])], 1)
        return apply

    res = lobpcg(columns("A", lambda x: spmv(A0, x)), X0,
                 T=columns("T", cycle),
                 opts=LOBPCGOptions(tol=1e-6, max_iter=100))
    return res, calls


def lobpcg_closed_form(nx: int, m: int) -> np.ndarray:
    """The m smallest eigenvalues of laplacian_7pt(nx^3): 6 - 2 cos(i pi /
    (nx + 1)) - 2 cos(j pi / (nx + 1)) - 2 cos(k pi / (nx + 1))."""
    c = np.cos(np.arange(1, 4) * np.pi / (nx + 1))
    lam = sorted(6 - 2 * (c[i] + c[j] + c[k]) for i in range(3)
                 for j in range(3) for k in range(3))
    return np.asarray(lam[:m])


def phase_lobpcg(dev, card):
    """(f) LOBPCG at 96^3 (m 4, the V-cycle as T): the JAX package's
    count, the eigenvalues the closed form's to 1e-6, the applications
    (m (1 + its) matvec columns, m its V-cycles) and exactly their
    launches.  Returns the numbers."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia import kernel_launches
    from hypre_tpu_torch.profile_slice import profile_solve
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    t0 = time.perf_counter()
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), slice_options(dtype="float64"),
                    device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    X0 = torch.from_numpy(np.random.default_rng(LOBPCG_SEED).standard_normal(
        (NX**3, LOBPCG_M))).to(dev)
    zero_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    res, calls = lobpcg_run(amg, X0)
    end.record()
    end.synchronize()
    counts = read_counts()
    lam = res.eigenvalues.cpu().numpy()
    want_lam = lobpcg_closed_form(NX, LOBPCG_M)
    lam_rel = float(np.max(np.abs(lam - want_lam) / want_lam))
    its = res.num_iterations
    expected = {name: 0 for name in counts}
    for name, c in kernel_launches(amg.levels[0].A).items():
        expected[name] += calls["A"] * c
    for name, c in amg.cycle_launches().items():
        expected[name] += calls["T"] * c
    ms = start.elapsed_time(end)
    # where a solve's device time goes: one more run under the profiler
    _, wall, busy_us, events, _ = profile_solve(lambda: lobpcg_run(amg, X0),
                                                cpu=False)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = [(name[:60], round(us / 1e3, 2)) for name, us in
           sorted(by_name.items(), key=lambda kv: -kv[1])[:4]]
    log(f"lobpcg [96^3 m {LOBPCG_M}; {card}]: {its} iterations (JAX "
        f"package: {LOBPCG96}), eigenvalues {lam.tolist()} (closed form "
        f"{want_lam.tolist()}, max rel err {lam_rel:.2e}), residual norms "
        f"{res.residual_norms.cpu().numpy().tolist()}; setup {setup_s:.2f} "
        f"s, solve {ms:.1f} ms; under the profiler wall {wall * 1e3:.1f} ms, "
        f"device busy {busy_us / 1e3:.1f} ms (idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.1f}%), the most device time "
        f"(ms): {top}; applications {calls}; launches {counts}")
    require(res.converged and its == LOBPCG96,
            f"lobpcg: {its} iterations, the JAX package's {LOBPCG96}")
    require(lam_rel <= 1e-6, f"lobpcg: eigenvalues {lam} are not the closed "
                             f"form's {want_lam}")
    require(calls == {"A": LOBPCG_M * (1 + its), "T": LOBPCG_M * its},
            f"lobpcg: applications {calls}")
    require(counts == expected, f"lobpcg: launches {counts} are not the "
                                f"applications' {expected}")
    return {"iterations": its, "eigenvalues": lam.tolist(),
            "closed_form": want_lam.tolist(), "max_rel_err": lam_rel,
            "setup_s": setup_s, "solve_ms": ms, "busy_ms": busy_us / 1e3,
            "wall_ms": wall * 1e3, "top_device_ms": top,
            "applications": calls, "launches": counts}


def phase_k1_systems(amg, flush, card):
    """K1 alone on the systems level 0 (19 offsets, 1,769,472 rows, f64):
    against its plain version, timed beside it and a cuSPARSE CSR product
    of the same operator's nonzeros; the bound on the DIA bytes (each
    diagonal, x and y once) and on the nonzero bytes (the values of the
    nonzeros, x and y).  Returns the numbers."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference

    A0 = amg.levels[0].A
    data, offs = A0.data, A0.offsets
    n = data.shape[1]
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(n)).to(
        data.device)
    y = dia_spmv_cuda(data, offs, x)
    y_ref = dia_spmv_reference(data, offs, x)
    torch.cuda.synchronize()
    err = float((y - y_ref).abs().max())
    rel = err / float(y_ref.abs().max())
    require(rel <= 1e-12, f"K1 on the systems level 0 disagrees with its "
                          f"plain version: rel {rel:.3e}")
    Ah = amg._host_A[0].tocsr()
    nnz = Ah.nnz
    with warnings.catch_warnings():  # torch's "sparse CSR is beta" notice
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(Ah.indptr.astype(np.int64)),
            torch.from_numpy(Ah.indices.astype(np.int64)),
            torch.from_numpy(Ah.data), size=Ah.shape).to(data.device)
    ms = time_cuda_ms(lambda: dia_spmv_cuda(data, offs, x), flush)
    plain_ms = time_cuda_ms(lambda: dia_spmv_reference(data, offs, x), flush)
    lib_ms = time_cuda_ms(lambda: csr @ x, flush)
    dia_bytes = (len(offs) + 2) * n * 8
    nz_bytes = (nnz + 2 * n) * 8
    bms, by = bound_ms(dia_bytes, 2 * len(offs) * n, torch.float64)
    nz_ms, _ = bound_ms(nz_bytes, 2 * nnz, torch.float64)
    fill = nnz / (len(offs) * n)
    log(f"K1 [systems level 0: {len(offs)} offsets {offs}, {n} rows, {nnz} "
        f"nonzeros, DIA slots {100 * fill:.0f}% filled; {card}], L2 flushed, "
        f"median of {REPS}: K1 {ms * 1e3:.1f} us ({dia_bytes / ms / 1e6:.0f} "
        f"GB/s on the DIA bytes), plain {plain_ms * 1e3:.1f} us, cuSPARSE "
        f"CSR {lib_ms * 1e3:.1f} us; bound {bms * 1e3:.1f} us on {dia_bytes / 1e6:.1f} "
        f"MB of DIA bytes, {nz_ms * 1e3:.1f} us on {nz_bytes / 1e6:.1f} MB of "
        f"nonzero bytes; max abs err {err:.2e}")
    return {"offsets": len(offs), "rows": n, "nnz": nnz, "fill": fill,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bms, "bound_by": by, "bound_nonzero_bytes_ms": nz_ms,
            "max_abs_err": err}


def cgnr_card_vs_cpu(dev, precond, want):
    """CGNR (`ij -solver 5` with the AMG V-cycle, `-solver 6` with the
    diagonal) on difconv_7pt(24^3) and its transpose (K1 both), max_iter
    50, on the card and on the CPU: the JAX package's count on both, the
    histories within 1e-10 relative entry by entry, the card's
    applications (1 + its of A, A^T and M) and exactly their launches."""
    from hypre_tpu_torch.ops.csr import CSRMatrix
    from hypre_tpu_torch.ops.dia import freeze_auto
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    A, _ = problem_matrix("difconv", 24)
    AT = CSRMatrix.from_scipy(A.to_scipy().T.tocsr())

    def run(where):
        amg = BoomerAMG(A, slice_options("ext+i", dtype="float64"),
                        device=where)
        A0 = amg.levels[0].A
        AT0 = freeze_auto(AT, torch.float64, where)
        b = torch.ones_like(amg.levels[0].dinv)
        solve, calls = krylov_solve(amg, "cgnr", {}, b, A0, AT0, precond)
        zero_counts()
        res = solve()
        counts = read_counts()
        return res, counts, dict(calls), amg, A0, AT0

    (rg, cg, calls, amg, A0, AT0), (rc, *_) = run(dev), run(torch.device("cpu"))
    its = rg.num_iterations
    expected = krylov_launches(amg, calls, A0, AT0, precond)
    hg, hc = rg.res_norms.cpu().numpy(), rc.res_norms.numpy()
    ok = ~np.isnan(hc)
    hist = float(np.max(np.abs(hg[ok] - hc[ok]) / hc[ok]))
    log(f"cgnr {precond} 24^3 card vs CPU: iterations {its} vs "
        f"{rc.num_iterations} (JAX package: {want}), converged "
        f"{rg.converged}; ||r|| / ||r0|| {hg[its] / hg[0]:.6f}; histories "
        f"within {hist:.2e} relative; applications {calls}; launches {cg}")
    require(its == rc.num_iterations == want,
            f"cgnr {precond}: {its} (card), {rc.num_iterations} (CPU), JAX "
            f"{want}")
    require(np.array_equal(np.isnan(hg), np.isnan(hc)) and hist <= 1e-10,
            f"cgnr {precond}: the card's history differs from the CPU's")
    require(calls == predicted_calls("cgnr", {}, its),
            f"cgnr {precond}: applications {calls}")
    require(cg == expected, f"cgnr {precond}: launches {cg} are not {expected}")
    return {"iterations": its, "converged": rg.converged,
            "history_rel": hist, "applications": calls, "launches": cg}


def lobpcg_card_vs_cpu(dev):
    """LOBPCG at 24^3 (m 4, the V-cycle as T) on the card and on the CPU:
    the JAX package's count on both, the eigenvalues within 1e-10
    relative of each other and the closed form's to 1e-6."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    X0 = np.random.default_rng(LOBPCG_SEED).standard_normal((24**3, LOBPCG_M))

    def run(where):
        amg = BoomerAMG(laplacian_7pt(24, 24, 24),
                        slice_options(dtype="float64"), device=where)
        return lobpcg_run(amg, torch.from_numpy(X0).to(where))[0]

    rg, rc = run(dev), run(torch.device("cpu"))
    lg, lc = rg.eigenvalues.cpu().numpy(), rc.eigenvalues.numpy()
    rel = float(np.max(np.abs(lg - lc) / lc))
    closed = float(np.max(np.abs(lg - lobpcg_closed_form(24, LOBPCG_M))
                          / lobpcg_closed_form(24, LOBPCG_M)))
    log(f"lobpcg 24^3 card vs CPU: iterations {rg.num_iterations} vs "
        f"{rc.num_iterations} (JAX package: {LOBPCG24}); eigenvalues "
        f"{lg.tolist()}, within {rel:.2e} of the CPU's, {closed:.2e} of the "
        f"closed form")
    require(rg.num_iterations == rc.num_iterations == LOBPCG24
            and rg.converged, f"lobpcg 24^3: {rg.num_iterations} (card), "
                              f"{rc.num_iterations} (CPU), JAX {LOBPCG24}")
    require(rel <= 1e-10 and closed <= 1e-6,
            "lobpcg 24^3: the eigenvalues differ")
    return {"iterations": rg.num_iterations, "eigenvalues": lg.tolist(),
            "rel_to_cpu": rel, "rel_to_closed_form": closed}


def phase_systems(dev, card):
    """14. Systems / nodal / GSMG BoomerAMG, the Krylov family and LOBPCG.
    At 96^3 through `run_cycle` (the JAX package's counts, launches
    exactly, statistics, setup by phase, median of 5, busy): (a) the
    oracle's nodal protocol on sys_laplacian_7pt x 2 with K1 alone timed
    at its 19-offset level 0 and every operator held against its plain
    version, (b) the unknown approach with ext+i, (c) (a) in f32/bf16, (d)
    GSMG; (e) the Krylov family on one convection-diffusion hierarchy
    (`run_krylov`); (f) LOBPCG.  At 24^3 card against CPU: nodal 1, 2,
    3, 4, 6 with nodal_diag 0 and 1, a user dof_func, GSMG with 3
    samples, the offset budgets on the lattice defaults with the JAX
    package's gates, CGNR with both preconditioners, LOBPCG.  Returns
    ({label: numbers} at 96^3, {label: numbers} at 24^3, K1's
    systems row)."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    out, k1_sys = {}, None
    for label, (kind, kw, want, slack) in SYS96.items():
        A, _ = problem_matrix(kind, NX)
        opts = slice_options(**{"dtype": "float64", **kw})
        amg, out[label] = run_cycle(opts, dev, card, label, want, slack, A=A)
        out[label]["levels"] = [a.shape[0] for a in amg._host_A]
        if label.startswith("(c)"):
            log(f"cycles [{label}]: the count above is held to the port's own "
                f"on the CPU; the JAX package's is {SYS96_F32_JAX}")
        if label.startswith("(a)"):
            k1_sys = phase_k1_systems(amg, flush, card)
            out[label]["held"] = phase_hold_operators(amg, 1e-12, label)
        del amg, A
        torch.cuda.empty_cache()
    # (e) one hierarchy, six solves
    A, _ = problem_matrix("difconv", NX)
    GLOBAL_TIMER.clear()
    t0 = time.perf_counter()
    amg = BoomerAMG(A, slice_options("ext+i", dtype="float64"), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in CYCLE_PHASES
              if GLOBAL_TIMER.seconds(k)}
    stats = statistics(amg)
    log(f"krylov [difconv 96^3 ext+i; {card}]: levels "
        f"{[a.shape[0] for a in amg._host_A]}; statistics {stats}; setup "
        f"{setup_s:.2f} s (phases {phases})")
    for label, ((name, kw), want) in KRYLOV96.items():
        out[f"(e) {label}"] = run_krylov(amg, label, name, kw, want, card,
                                         amg.levels[0].A)
        out[f"(e) {label}"].update(statistics=stats, setup_s=setup_s,
                                   phases=phases)
    del amg, A, flush
    torch.cuda.empty_cache()
    out["(f) lobpcg"] = phase_lobpcg(dev, card)
    torch.cuda.empty_cache()
    # 24^3, card against CPU
    small = {}
    for label, (kind, kw, want) in SYS24.items():
        A, dof = problem_matrix(kind, 24)
        if dof is not None:
            kw = dict(kw, dof_func=dof)
        small[label] = card_vs_cpu(24, slice_options(dtype="float64", **kw),
                                   dev, label, want, A=A)
    for label, (kw, want) in BUDGET24.items():
        small[label] = card_vs_cpu(
            24, lattice_options(24, dtype="float64", relocate_min_n2=0, **kw),
            dev, label, want, BUDGET24_GATES)
    for precond, want in CGNR24.items():
        small[f"cgnr {precond}"] = cgnr_card_vs_cpu(dev, precond, want)
    small["lobpcg"] = lobpcg_card_vs_cpu(dev)
    return out, small, k1_sys


# -- 15. the ij driver, IJ assembly, checkpoints, AMG hybrid, ILU and the
# -- complex smoothers ----------------------------------------------------

# The oracle line (BASELINE.md): hypre's 25 iterations, and the JAX
# package's on the CPU; its complexity lines as the JAX driver prints
# them at 96^3; AMG hybrid's DS-PCG and AMG-PCG phases and ILU(1)-GMRES,
# the JAX package's CPU counts.  `python -m pytest -m slow
# tests/test_torch_ij_pins.py` recomputes them (the JAX package on the
# CPU with its lattice forms off: they change the hierarchy's operators
# only by rounding, and its 96^3 lattice build needs ~50 GB of host
# memory; ~1 min).
IJ96_ORACLE = "-n 96 96 96 -solver 1 -pmis -interptype 0 -Pmx 4 -rlx 18 -tol 1e-6"
IJ96_ITERS = 25
IJ96_COMPLEXITY = ("1.388158", "2.246793")  # grid, operator
IJ96_HYBRID = "-n 96 96 96 -solver 20 -rlx 18"
IJ96_HYBRID_ITERS = (2, 17)  # DS-PCG, then AMG-PCG
IJ96_ILU = "-n 96 96 96 -solver 81 -ilu_lfil 1 -k 20 -max_iter 500 -tol 1e-6"
IJ96_ILU_ITERS = 79
# the complex smoothers on 2 levels under AMG-GMRES (PCG stalls with
# the restricted additive Schwarz smoother, which is not symmetric, in
# both packages), card against CPU
IJ48_SMOOTHERS = {st: f"-n 48 48 48 -solver 3 -smtype {st} -smlv 2"
                  for st in (6, 8, 9)}
# every other solver id at 24^3, card against CPU (CGNR stops at 20
# iterations unconverged, as in tests/test_torch_ij_driver.py)
IJ24 = {s: f"-n 24 24 24 -solver {s}" for s in (0, 2, 3, 4, 9, 10, 16, 50,
                                                 51, 60, 61, 80)}
IJ24.update({5: "-n 24 24 24 -solver 5 -max_iter 20",
             6: "-n 24 24 24 -solver 6 -max_iter 20"})
# DS-BiCGSTAB's residual is not monotone near the tolerance: the card's
# and the CPU's dot products sum in another order, and its count moved
# by 2 (40 on the card, 42 on the CPU; measured on one H100).  Such a
# line is held to converging on both within the slack, x within 1e-8
# (1.01e-9 measured), and its printout with only the count's and the
# residual's numbers masked.
IJ24_SLACK = {10: 2}
IJ_ADDS = 3  # the inexact AddTo calls an entry in (d)'s second stream
# (d)'s second stream runs over laplacian_7pt(48^3)'s nonzeros (96^3,
# 13.8 s of host assembly, until phase 20 came)
IJ_INEXACT_NX = 48
IJ_PHASES = ("SETUP", "STRENGTH", "COARSEN", "INTERP", "RAP", "FREEZE",
             "DEVICE_RAP", "COLLAPSE", "ILU_FACTOR", "ILU_SCHEDULE",
             "SMOOTHER_SETUP")
_NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")


def drive(line: str, device):
    """The port's ij driver on one command line, its printout captured
    and logged.  Returns (result, printout, wall seconds)."""
    import contextlib
    import io

    from hypre_tpu_torch.drivers import ij

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = ij.run(line.split(), device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for ln in buf.getvalue().splitlines():
        log(f"  ij [{torch.device(device).type}] {ln}")
    return res, buf.getvalue(), wall


def true_residual(A0, x, tol: float):
    """(||b - A x|| / ||b|| in float64 with b = ones and K1's plain
    version, the bound it must meet: tol + 4 eps ||A||_inf ||x|| /
    ||b||), finite x required."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_reference

    require(bool(torch.isfinite(x).all()), "non-finite solution")
    d64, x64 = A0.data.double(), x.double()
    b = torch.ones_like(x64)
    r = b - dia_spmv_reference(d64, A0.offsets, x64)
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(r)) / nb
    bound = tol + 4 * torch.finfo(x.dtype).eps * float(
        d64.abs().sum(0).max()) * float(torch.linalg.vector_norm(x64)) / nb
    return rel, bound


def ij_timing(solve, its: int) -> dict:
    """The solve's median of 5 and one profiled run (`busy`)."""
    med, lo, hi = solve_median_ms(solve)
    return {"solve_median_ms": med, "solve_min_max_ms": [lo, hi],
            **busy(solve, its)}


def ij_phases() -> dict:
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    return {k: round(GLOBAL_TIMER.seconds(k), 4) for k in IJ_PHASES
            if GLOBAL_TIMER.seconds(k)}


def ij_pcg(amg, op, tol=1e-6, max_iter=100):
    """solve() -> the driver's AMG-PCG over `amg` and the operator `op`
    (b = ones, two-norm)."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    b = torch.ones(op.num_rows, dtype=torch.float64, device=op.data.device)
    return lambda: pcg(lambda x: spmv(op, x), b, M=amg.precond,
                       opts=PCGOptions(tol=tol, max_iter=max_iter,
                                       two_norm=True))


def ij_oracle(dev, card):
    """(a) the oracle line through the driver at 96^3 and (f) its
    hierarchy saved, loaded on the card and solved again."""
    import os
    import tempfile

    from hypre_tpu_torch.utils.io import load_amg_hierarchy, save_amg_hierarchy
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    res, out, wall = drive(IJ96_ORACLE, dev)
    counts = read_counts()
    amg, its = res.amg, res.num_iterations
    phases = ij_phases()
    expected = expected_launches(amg, its)
    rel, bound = true_residual(res.op, res.x, 1e-6)
    cplx = tuple(ln.split("=")[1].strip() for ln in out.splitlines()
                 if "grid =" in ln or "operator =" in ln)
    timing = ij_timing(ij_pcg(amg, res.op), its)
    log(f"ij oracle line 96^3 ({card}): {its} iterations (hypre and the JAX "
        f"package: {IJ96_ITERS}), true rel residual {rel:.3e} (bound "
        f"{bound:.1e}), complexities {cplx} (JAX driver: {IJ96_COMPLEXITY}); "
        f"driver wall {wall:.2f} s, setup phases {phases}; {timing}; "
        f"launches {counts}, expected {expected}")
    require(res.converged and its == IJ96_ITERS,
            f"ij oracle line: {its} iterations, pinned {IJ96_ITERS}")
    require(rel < bound, f"ij oracle line: true residual {rel:.3e}")
    require(cplx == IJ96_COMPLEXITY, f"ij oracle line: complexities {cplx}, "
                                     f"the JAX driver's {IJ96_COMPLEXITY}")
    require(counts == expected, f"ij oracle line: launches {counts} are not "
                                f"the hierarchy's {expected}")
    require(counts["dia_spmv_tail"] > 0 and counts["cell_dense"] > 0,
            "ij oracle line: the lattice forms did not engage")
    oracle = {"iterations": its, "true_rel_residual": rel,
              "complexity": list(cplx), "driver_wall_s": wall,
              "setup_phases": phases, **timing, "launches": counts}

    # (f) the checkpoint: save, load on the card, the same solve
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ij96.npz")
        t0 = time.perf_counter()
        save_amg_hierarchy(amg, path)
        save_s = time.perf_counter() - t0
        mb = os.path.getsize(path) / 2**20
        t0 = time.perf_counter()
        amg2 = load_amg_hierarchy(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    zero_counts()
    res2 = ij_pcg(amg2, res.op)()
    torch.cuda.synchronize()
    counts2 = read_counts()
    same = bool(torch.equal(res2.x, res.x))
    log(f"ij checkpoint 96^3 ({card}): save {save_s:.2f} s ({mb:.1f} MB), "
        f"load and freeze on the card {load_s:.2f} s; {res2.num_iterations} "
        f"iterations, x bitwise the driver's run: {same}; launches {counts2}")
    require(res2.num_iterations == its and same,
            f"ij checkpoint: {res2.num_iterations} iterations, x bitwise "
            f"{same}")
    require(counts2 == expected_launches(amg2, its),
            f"ij checkpoint: launches {counts2}")
    ckpt = {"save_s": save_s, "load_s": load_s, "file_mb": mb,
            "iterations": res2.num_iterations, "x_bitwise": same,
            "launches": counts2}
    return oracle, ckpt


def ij_hybrid(dev, card):
    """(b) AMG hybrid at 96^3: DS-PCG until cf_tol, then AMG-PCG."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    res, _, wall = drive(IJ96_HYBRID, dev)
    counts = read_counts()
    h = res.hybrid
    ds, amg_its = h.phase_iterations
    expected = expected_launches(h._amg, amg_its)
    expected["dia_spmv"] += ds + 1  # DS-PCG's matvecs
    rel, bound = true_residual(res.op, res.x, 1e-8)
    phases = ij_phases()
    log(f"ij hybrid 96^3 ({card}): DS-PCG {ds} then AMG-PCG {amg_its} "
        f"iterations (JAX package: {IJ96_HYBRID_ITERS}), true rel residual "
        f"{rel:.3e} (bound {bound:.1e}); driver wall {wall:.2f} s, setup "
        f"phases {phases}; launches {counts}")
    require(res.converged and (ds, amg_its) == IJ96_HYBRID_ITERS,
            f"ij hybrid: phases {(ds, amg_its)}, pinned {IJ96_HYBRID_ITERS}")
    require(rel < bound, f"ij hybrid: true residual {rel:.3e}")
    require(counts == expected, f"ij hybrid: launches {counts} are not "
                                f"{expected}")
    return {"iterations": [ds, amg_its], "true_rel_residual": rel,
            "driver_wall_s": wall, "setup_phases": phases,
            "launches": counts}


def ij_ilu(dev, card):
    """(c) ILU(1)-GMRES at 96^3: every preconditioner application two
    gs_sweep launches (L forward, U backward)."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.ops.dia import kernel_launches
    from hypre_tpu_torch.solvers.krylov import GMRESOptions, gmres
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    GLOBAL_TIMER.clear()
    zero_counts()
    res, _, wall = drive(IJ96_ILU, dev)
    require_no_gs_fault(dev, "ij ILU(1)-GMRES")
    counts = read_counts()
    its, ilu = res.num_iterations, res.ilu
    calls = predicted_calls("gmres", {"k_dim": 20}, its)
    expected = {name: 0 for name in counts}
    for name, c in kernel_launches(res.op).items():
        expected[name] += calls["A"] * c
    expected["gs_sweep"] = 2 * calls["M"]
    rel, bound = true_residual(res.op, res.x, 1e-6)
    phases = ij_phases()
    b = torch.ones(res.op.num_rows, dtype=torch.float64, device=dev)
    timing = ij_timing(lambda: gmres(
        lambda x: spmv(res.op, x), b, M=ilu.precond,
        opts=GMRESOptions(tol=1e-6, max_iter=500, k_dim=20)), its)
    Ls, Us = ilu._Lsched, ilu._Usched
    shape = {"L_nnz": int(ilu.L.nnz), "U_nnz": int(ilu.U.nnz),
             "wavefronts": [Ls.num_wavefronts, Us.num_wavefronts],
             "max_row": [Ls.max_row, Us.max_row]}
    held = hold_ilu(ilu, card)
    log(f"ij ILU(1)-GMRES 96^3 ({card}): {its} iterations (JAX package: "
        f"{IJ96_ILU_ITERS}), true rel residual {rel:.3e} (bound "
        f"{bound:.1e}); factors {shape}; factor {phases.get('ILU_FACTOR')} s, "
        f"schedules {phases.get('ILU_SCHEDULE')} s; driver wall {wall:.2f} s; "
        f"{timing}; applications {calls}, launches {counts}")
    require(res.converged and its == IJ96_ILU_ITERS,
            f"ij ILU: {its} iterations, the JAX package's {IJ96_ILU_ITERS}")
    require(rel < bound, f"ij ILU: true residual {rel:.3e}")
    require(counts == expected and counts["gs_sweep"] == 2 * calls["M"] > 0,
            f"ij ILU: launches {counts} are not {expected}")
    return {"iterations": its, "true_rel_residual": rel, "factors": shape,
            "setup_phases": phases, "driver_wall_s": wall, **timing,
            "applications": calls, "launches": counts, "held": held}


def hold_ilu(ilu, card) -> dict:
    """gs_sweep on the ILU factors' schedules against its plain version:
    each sweep as hold_gs holds it (f64, 1e-12), and one whole
    application, L forward and U backward from zero through the wrapper
    (ILU.solve), against gs_sweep_reference over the same slabs."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_reference

    rng = np.random.default_rng(15)
    Ls, Us = ilu._Lsched, ilu._Usched
    errs = {}
    for name, S in (("L", Ls), ("U", Us)):
        errs[name], _ = hold_gs(S, f"ILU(1) {name} 96^3", torch.float64,
                                1e-12, rng)
    dev, n = Ls.order.device, Ls.n
    r = torch.from_numpy(rng.standard_normal(n)).to(dev)
    got = ilu.solve(r)
    y = gs_sweep_reference(Ls.slabs(dev), n, torch.zeros_like(r), r)
    want = gs_sweep_reference(Us.slabs(dev), n, torch.zeros_like(y), y)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    require_no_gs_fault(dev, "ILU(1) application")
    log(f"gs_sweep on the ILU(1) factors 96^3 ({card}): L / U sweeps vs "
        f"plain max abs err {errs['L']:.3e} / {errs['U']:.3e}; one "
        f"application (ILU.solve) vs the plain pair: max abs err {err:.3e}, "
        f"rel {rel:.3e}")
    require(rel <= 1e-12, f"ILU(1) application disagrees with the plain "
                          f"triangular pair: rel {rel:.3e}")
    return {"L_sweep_err": errs["L"], "U_sweep_err": errs["U"],
            "application_err": err, "application_rel": rel}


def ij_assembly(dev, card):
    """(d) IJ assembly of laplacian_7pt(96, 96, 96) on the host and on the
    card from one seeded interleaved Set/AddTo stream: per entry a noise
    AddTo, a Set of value - d and an AddTo of d (d a power of two, so the
    sum is exact), the entries' three calls merged at random across 16
    chunks.  Both must equal the operator bitwise."""
    from hypre_tpu_torch.models import (IJMatrix, IJMatrixDevice,
                                        ij_assemble_device, laplacian_7pt)

    A = laplacian_7pt(NX, NX, NX)
    C = A.to_scipy().tocoo()
    n, nnz = A.shape[0], C.nnz
    rng = np.random.default_rng(14)
    d = rng.choice([0.25, 0.5, 1.0, 2.0], nnz)
    noise = rng.standard_normal(nnz)
    chunks = np.array_split(rng.permutation(nnz), 16)
    tokens = np.repeat(np.arange(16), 3)
    rng.shuffle(tokens)
    host, card_ij = IJMatrix(n, n), IJMatrixDevice(n, n, device=dev)
    step = [0] * 16
    for c in tokens:
        e = chunks[c]
        r, k = C.row[e], C.col[e]
        for M in (host, card_ij):
            if step[c] == 0:
                M.add_to_values(r, k, noise[e])
            elif step[c] == 1:
                M.set_values(r, k, C.data[e] - d[e])
            else:
                M.add_to_values(r, k, d[e])
        step[c] += 1
    t0 = time.perf_counter()
    Ah = host.assemble()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ad = card_ij.assemble()
    card_s = time.perf_counter() - t0
    streams = card_ij._streams()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ij_assemble_device(*streams, A.shape, device=dev)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, out))
    card_ms = [r[0] for r in runs[1:]]
    same = [all(np.array_equal(getattr(X, f), getattr(A, f))
                for f in ("indptr", "indices", "data")) for X in (Ah, Ad)]
    log(f"ij assembly 96^3 ({card}): {len(streams[0])} stream entries "
        f"({nnz} nonzeros); host assemble {host_s:.2f} s, card assemble "
        f"{card_s:.2f} s (with the host CSR build), card sort + reductions "
        f"{runs[1][0] * 1e3:.1f} / {runs[2][0] * 1e3:.1f} ms; equal to "
        f"laplacian_7pt bitwise: host {same[0]}, card {same[1]}")
    require(all(same), f"ij assembly: host / card equal the operator {same}")
    del host, card_ij, streams, runs
    inexact = ij_assembly_inexact(laplacian_7pt(
        IJ_INEXACT_NX, IJ_INEXACT_NX, IJ_INEXACT_NX).to_scipy().tocoo(), dev,
        card)
    return {"entries": 3 * nnz, "host_s": host_s, "card_s": card_s,
            "card_device_ms": [t * 1e3 for t in card_ms],
            "bitwise": same, "inexact": inexact}


def ij_assembly_inexact(C, dev, card) -> dict:
    """A second stream over the IJ_INEXACT_NX^3 operator's nonzeros whose sums are
    inexact: per entry a Set of its value, then IJ_ADDS AddTo calls of
    seeded normal values, the entries' calls merged at random across 16
    chunks.  Each of two card runs of ij_assemble_device (index_add_'s
    atomics add in no fixed order) is held to the host accumulator
    within 1e-12 absolute; whether the two repeat bitwise is reported."""
    from hypre_tpu_torch.models import IJMatrix, ij_assemble_device

    nnz = C.nnz
    rng = np.random.default_rng(141)
    adds = rng.standard_normal((IJ_ADDS, nnz))
    chunks = np.array_split(rng.permutation(nnz), 16)
    tokens = np.repeat(np.arange(16), 1 + IJ_ADDS)
    rng.shuffle(tokens)
    host, step = IJMatrix(*C.shape), [0] * 16
    for c in tokens:
        e = chunks[c]
        if step[c] == 0:
            host.set_values(C.row[e], C.col[e], C.data[e])
        else:
            host.add_to_values(C.row[e], C.col[e], adds[step[c] - 1, e])
        step[c] += 1
    streams = host._streams()
    t0 = time.perf_counter()
    Ah = host.assemble()
    host_s = time.perf_counter() - t0
    hr = np.repeat(np.arange(C.shape[0]), np.diff(Ah.indptr))
    runs, errs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ur, uc, uv = ij_assemble_device(*streams, C.shape, device=dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        require(np.array_equal(ur.cpu().numpy(), hr)
                and np.array_equal(uc.cpu().numpy(), Ah.indices),
                "ij inexact assembly: the card's pattern is not the host's")
        errs.append(float(np.abs(uv.cpu().numpy() - Ah.data).max()))
        runs.append((ms, uv))
    repeat = bool(torch.equal(runs[0][1], runs[1][1]))
    ndiff = int((runs[0][1] != runs[1][1]).sum())
    log(f"ij inexact assembly {IJ_INEXACT_NX}^3 ({card}): {len(streams[0])} stream "
        f"entries (a Set and {IJ_ADDS} inexact AddTo an entry); host "
        f"assemble {host_s:.2f} s, card sort + reductions "
        f"{runs[0][0]:.1f} / {runs[1][0]:.1f} ms; card vs host max abs "
        f"diff {errs[0]:.3e} / {errs[1]:.3e}; two card runs bitwise: "
        f"{repeat} ({ndiff} entries differ)")
    require(max(errs) <= 1e-12, f"ij inexact assembly: card vs host {errs}")
    return {"entries": len(streams[0]), "host_s": host_s,
            "card_device_ms": [r[0] for r in runs], "max_abs_vs_host": errs,
            "card_repeats_bitwise": repeat, "entries_differing": ndiff}


def ij_card_vs_cpu(line: str, label: str, card, slack: int = 0) -> dict:
    """One driver line on the card (counts at 0 before, read after) and on
    the CPU: the same printout with the numbers masked, the same count,
    x within 1e-9, the final relative residuals within 1e-10 or the
    rounding floor of b - A x (64 eps ||A||_inf ||x|| / ||b||).  With a
    count slack: both converge, the counts within it, x within 1e-8."""
    zero_counts()
    rg, og, wall_g = drive(line, torch.device("cuda", 0))
    counts = read_counts()
    require_no_gs_fault(torch.device("cuda", 0), label)
    rc, oc, wall_c = drive(line, "cpu")
    a, b = float(rg.rel_residual_norm), float(rc.rel_residual_norm)
    xg = rg.x.cpu()
    dx = float((xg - rc.x).abs().max() / rc.x.abs().max())
    from hypre_tpu_torch.ops.dia import DenseMatrix

    absA = rc.op.data.double().abs()  # DIA / ELL [k, n], dense [n, n]
    norm_a = float((absA.sum(1) if isinstance(rc.op, DenseMatrix)
                    else absA.sum(0)).max())
    floor = (64 * torch.finfo(torch.float64).eps * norm_a
             * float(torch.linalg.vector_norm(rc.x))
             / float(torch.linalg.vector_norm(torch.ones_like(rc.x))))
    its = rg.num_iterations
    log(f"ij {label} ({card}): card {its} / CPU {rc.num_iterations} "
        f"iterations, rel residual {a:.10e} vs {b:.10e} (floor {floor:.1e}), "
        f"max rel diff of x {dx:.2e}; card {wall_g:.2f} s, CPU {wall_c:.2f} "
        f"s; launches {counts}")
    def masked(out):  # with a slack, the count's line masked as well
        out = _NUM.sub("#", out)
        return re.sub(r"Iterations = \d+", "Iterations = #", out) if slack else out

    require(masked(og) == masked(oc),
            f"ij {label}: the card's printout differs from the CPU's")
    if its != rc.num_iterations and slack:
        require(rg.converged and rc.converged
                and abs(its - rc.num_iterations) <= slack and dx <= 1e-8,
                f"ij {label}: the card's solve differs from the CPU's "
                f"beyond the slack {slack}")
    else:
        require(its == rc.num_iterations and dx <= 1e-9
                and abs(a - b) <= max(1e-10 * b, floor),
                f"ij {label}: the card's solve differs from the CPU's")
    require(sum(counts.values()) > 0, f"ij {label}: no kernel launched")
    return {"iterations": its, "cpu_iterations": rc.num_iterations,
            "rel_residual_norm": a,
            "cpu_rel_residual_norm": b, "card_wall_s": wall_g,
            "cpu_wall_s": wall_c, "launches": counts}


def phase_ij(dev, card):
    """Phase 15: the ij driver and what it reaches (module docstring)."""
    t0 = time.perf_counter()
    runs = {}
    runs["oracle 96"], runs["checkpoint 96"] = ij_oracle(dev, card)
    torch.cuda.empty_cache()
    runs["hybrid 96"] = ij_hybrid(dev, card)
    torch.cuda.empty_cache()
    runs["ilu 96"] = ij_ilu(dev, card)
    torch.cuda.empty_cache()
    assembly = ij_assembly(dev, card)
    torch.cuda.empty_cache()
    for st, line in IJ48_SMOOTHERS.items():
        runs[f"smtype {st} 48"] = ij_card_vs_cpu(line, f"smtype {st} 48^3",
                                                 card)
    small = {}
    for s, line in IJ24.items():
        small[s] = ij_card_vs_cpu(line, f"solver {s} 24^3", card,
                                  IJ24_SLACK.get(s, 0))
    runs["solver ids 24"] = {"launches": {
        name: sum(v["launches"][name] for v in small.values())
        for name in read_counts()}}
    log(f"the ij phase took {time.perf_counter() - t0:.1f} s")
    return runs, assembly, small


# -- 16. the AMG family -------------------------------------------------------

# The JAX package's counts at the card sizes, computed on a CPU with the
# JAX package and recomputed by `python -m pytest -m slow
# tests/test_torch_{sa,pilut,mgr,ams,amgdd,block_amg}.py -k chip_pin`.
# Sizes cut from the ones first planned, each for a fault both packages
# share (ROADMAP Queue 3): ADS at 13^3 (its RT nodal AMG keeps one level,
# a dense pinv of 3 (n+1)^3 rows; 13^3 is the least size whose face and
# curl-space operators leave the dense path), AMG-DD at 24^3 (at 48^3 the solve
# does not reach 1e-8 in 100 iterations), block AMG at 24^3 (at 48^3 its
# V-cycle is no SPD preconditioner: PCG stops on a NaN residual).
AUX_SA96 = 21  # SA-PCG, laplacian_7pt(96^3), tol 1e-6
AUX_PILUT48 = (33, 2)  # PILUT-GMRES(30) at 48^3, tol 1e-8: (iterations, stages)
MGR_BLK = dict(interp_type="blk_jacobi", restrict_type="blk_jacobi",
               frelax="amg", blk_size=2, coarse_grid_method="galerkin")
# MGR-FlexGMRES(10) on sys_laplacian_7pt(48^3, 2), function 1 C, tol 1e-8:
# {label: (options, iterations)}; the default line stops unconverged at
# max_iter 100 (AUX_MGR48_DEFAULT_REL: its final relative residual)
AUX_MGR48 = {"default": ({}, 100), "blk_jacobi": (MGR_BLK, 19)}
AUX_MGR48_DEFAULT_REL = 0.11860760775943988
# AMS-PCG, curlcurl_matrix(48^3), tol 1e-6: (its, G-space); 64^3 until
# phase 19 came (the same (9, True))
AUX_AMS48 = (9, True)
AUX_ADS13 = 1  # ADS-PCG, divdiv_matrix(13^3), tol 1e-6
# AME, curlcurl_matrix(16^3), M = I, AMEOptions(): (iterations, eigenvalues)
AUX_AME16 = (56, (1.068107601264485, 1.0681076012646722, 1.068107601264822,
                  1.1021614018971027))
AUX_DD24 = 64  # AMGDD.solve, laplacian_7pt(24^3), 8 domains, tol 1e-8
AUX_BLOCK24 = {"direct": 26, "classical": 25}  # BlockAMG-PCG, 24^3 x 2, 1e-8
DD_AMG = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=18, relax_up=18, embed_level1=False)


def expect(parts) -> dict:
    """{kernel: launches} of [(an application's launches, applications)],
    every counted kernel present."""
    from hypre_tpu_torch.ops.dia import sum_launches

    return {name: 0 for name in read_counts()} | sum_launches(parts)


def host_rel(As, b, x) -> float:
    """||b - A x|| / ||b|| in float64 on the host; finite x required."""
    xh = x.double().cpu().numpy()
    require(bool(np.isfinite(xh).all()), "non-finite solution")
    bh = b.double().cpu().numpy()
    return float(np.linalg.norm(bh - As @ xh) / np.linalg.norm(bh))


def hold_family_ops(ops, label) -> int:
    """`hold_ops` on a solver's frozen operators [(name, A)] in the forms
    the solvers run (plain, resid, axpy; jacobi where square), 1e-12.
    Returns the number of applications held."""
    return hold_ops(
        [(n, A, A.num_cols, A.num_rows, ("plain", "resid", "axpy") + (
            ("jacobi",) if A.num_rows == A.num_cols else ())) for n, A in ops],
        1e-12, label, np.random.default_rng(43), torch.float64,
        ops[0][1].data.device)["applications"]


def hold_amgs(amgs, label) -> int:
    """phase_hold_operators on each BoomerAMG of more than one level."""
    n = 0
    for name, amg in amgs:
        if amg is not None and len(amg.levels) > 1:
            n += phase_hold_operators(amg, 1e-12, f"{label} {name}")["applications"]
    return n


def family_line(label, card, its, want, rel, setup_s, solve_ms, counts,
                expected, **extra) -> dict:
    """Log one line of phase 16 and hold it: the JAX package's count,
    launches exactly as predicted."""
    log(f"family [{label}; {card}]: {its} iterations (JAX package: {want}), "
        f"true rel residual {rel:.3e}; setup {setup_s:.2f} s, solve "
        f"{solve_ms:.2f} ms; {extra}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    require(its == want, f"family {label}: {its} iterations, the JAX "
                         f"package's {want}")
    require(counts == expected, f"family {label}: launches {counts} are not "
                                f"the predicted {expected}")
    return {"iterations": its, "true_rel_residual": rel, "setup_s": setup_s,
            "solve_ms": solve_ms, "launches": counts, **extra}


def family_sa(dev, card):
    """(a) SA-AMG-PCG at 96^3."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia import freeze_auto, kernel_launches, spmv
    from hypre_tpu_torch.solvers.amg.smoothed_aggregation import (
        SAOptions, SmoothedAggregationAMG)
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    A = laplacian_7pt(96, 96, 96)
    zero_counts()
    t0 = time.perf_counter()
    sa = SmoothedAggregationAMG(A, SAOptions(), device=dev)
    E = freeze_auto(A, torch.float64, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    solve = lambda: pcg(lambda x: spmv(E, x), b, M=sa.precond,  # noqa: E731
                        opts=PCGOptions(tol=1e-6, max_iter=200))
    res = solve()
    counts = read_counts()
    its = res.num_iterations
    calls = predicted_calls("pcg", {}, its)
    expected = expect([(kernel_launches(E), calls["A"]),
                       (sa.cycle_launches(), calls["M"])])
    ms = solve_median_ms(solve, reps=1)[0]
    out = family_line("(a) SA-PCG 96^3", card, its, AUX_SA96,
                      host_rel(A.to_scipy(), b, res.x), setup_s, ms, counts,
                      expected, levels=[describe(l["A"])[0] for l in sa.levels],
                      **busy(solve, its))
    out["held"] = hold_family_ops(
        [(f"L{k} {n}", lv[n]) for k, lv in enumerate(sa.levels)
         for n in ("A", "R", "P") if lv[n] is not None], "(a) SA")
    return out


def pilut_plain(p, k, r):
    """PILUT's application from stage k through the plain versions alone
    (gs_sweep_reference, plain_spmv), on r's device."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_reference

    dev = r.device

    def sweep(S, f):
        return gs_sweep_reference(S.slabs(dev), S.n, torch.zeros_like(f), f)

    if k == len(p.stages):
        return sweep(p._tail._Usched, sweep(p._tail._Lsched, r))
    st = p.stages[k]
    rp = r[st["perm"]]
    rB, rS = rp[: st["ni"]], rp[st["ni"]:]
    yB = sweep(st["Ls"], rB)
    xS = pilut_plain(p, k + 1, rS - plain_spmv(st["L_EB"], yB))
    xB = sweep(st["Us"], yB - plain_spmv(st["U_BF"], xS))
    return torch.cat([xB, xS])[st["iperm"]]


def family_pilut(dev, card):
    """(b) PILUT-GMRES(30) at 48^3, every schedule and one whole
    application held against the plain versions."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia import freeze_auto, kernel_launches, spmv
    from hypre_tpu_torch.solvers.amg.pilut import PILUT, PILUTOptions
    from hypre_tpu_torch.solvers.krylov import GMRESOptions, gmres

    A = laplacian_7pt(48, 48, 48)
    zero_counts()
    t0 = time.perf_counter()
    p = PILUT(A, PILUTOptions(), device=dev)
    E = freeze_auto(A, torch.float64, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    solve = lambda: gmres(lambda x: spmv(E, x), b, M=p.precond,  # noqa: E731
                          opts=GMRESOptions(tol=1e-8, max_iter=200, k_dim=30))
    res = solve()
    require_no_gs_fault(dev, "(b) PILUT-GMRES")
    counts = read_counts()
    its = res.num_iterations
    calls = predicted_calls("gmres", {"k_dim": 30}, its)
    expected = expect([(kernel_launches(E), calls["A"]),
                       (p.apply_launches(), calls["M"])])
    ms = solve_median_ms(solve, reps=1)[0]
    want_its, want_stages = AUX_PILUT48
    require(len(p.stages) == want_stages,
            f"(b) PILUT: {len(p.stages)} stages, the JAX package's "
            f"{want_stages}")
    shapes = [{"ni": st["ni"], "n": st["n"],
               "wavefronts": [st["Ls"].num_wavefronts, st["Us"].num_wavefronts]}
              for st in p.stages]
    out = family_line("(b) PILUT-GMRES 48^3", card, its, want_its,
                      host_rel(A.to_scipy(), b, res.x), setup_s, ms, counts,
                      expected, stages=shapes, applications=calls["M"])
    require(counts["gs_sweep"] == (2 * len(p.stages) + 2) * calls["M"],
            "(b) PILUT: gs_sweep launches are not 2 a stage and 2 for the "
            "tail an application")
    rng = np.random.default_rng(47)
    errs = []
    scheds = [(f"stage {k} {n}", st[n]) for k, st in enumerate(p.stages)
              for n in ("Ls", "Us")]
    scheds += [("tail L", p._tail._Lsched), ("tail U", p._tail._Usched)]
    for name, S in scheds:
        errs.append(hold_gs(S, f"PILUT 48^3 {name}", torch.float64, 1e-12,
                            rng)[0])
    r = torch.from_numpy(rng.standard_normal(A.num_rows)).to(dev)
    got, want = p.solve(r), pilut_plain(p, 0, r)
    require_no_gs_fault(dev, "(b) PILUT application")
    app_rel = float((got - want).abs().max() / want.abs().max())
    log(f"gs_sweep on PILUT's {len(scheds)} schedules 48^3 ({card}): max abs "
        f"err {max(errs):.3e}; one PILUT.solve against the plain chain: rel "
        f"{app_rel:.3e}")
    require(app_rel <= 1e-12, f"(b) PILUT application differs from the plain "
                              f"chain: rel {app_rel:.3e}")
    out["held"] = {"schedules": len(scheds), "sweep_err": max(errs),
                   "application_rel": app_rel,
                   "operators": hold_family_ops(
                       [("A", E)] + [(f"stage {k} {n}", st[n]) for k, st in
                                     enumerate(p.stages)
                                     for n in ("L_EB", "U_BF")],
                       "(b) PILUT")}
    return out


def family_mgr(dev, card, label):
    """(c) MGR-FlexGMRES on sys_laplacian_7pt(48^3, 2), function 1 C."""
    from hypre_tpu_torch.models import sys_laplacian_7pt
    from hypre_tpu_torch.ops.dia import freeze_auto, kernel_launches
    from hypre_tpu_torch.solvers.amg.mgr import MGR, MGROptions

    opts, want = AUX_MGR48[label]
    A = sys_laplacian_7pt(48, 48, 48, 2)
    cm = np.arange(A.num_rows) % 2 == 1
    zero_counts()
    t0 = time.perf_counter()
    m = MGR(A, cm, MGROptions(**opts), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    res = m.solve(A, b, tol=1e-8)
    counts = read_counts()
    its = res.num_iterations
    calls = predicted_calls("flexgmres", {"k_dim": 10}, its)
    E = freeze_auto(A, torch.float64, dev)
    expected = expect([(kernel_launches(E), calls["A"]),
                       (m.apply_launches(), calls["M"])])
    ms = solve_median_ms(lambda: m.solve(A, b, tol=1e-8), reps=1)[0]
    rel = host_rel(A.to_scipy(), b, res.x)
    out = family_line(f"(c) MGR {label} 48^3", card, its, want, rel, setup_s,
                      ms, counts, expected, converged=res.converged,
                      final_rel=float(res.rel_residual_norm))
    if label == "default":
        got = float(res.rel_residual_norm)
        require(abs(got - AUX_MGR48_DEFAULT_REL) <= 1e-8 * AUX_MGR48_DEFAULT_REL,
                f"(c) MGR default: final rel residual {got!r}, the JAX "
                f"package's {AUX_MGR48_DEFAULT_REL!r}")
    lv = m.levels[0]
    ops = [("A", E)] + [(n, lv[n]) for n in ("Aff", "Acf", "Wp", "Wr", "Bffi")
                        if lv[n] is not None]
    out["held"] = hold_family_ops(ops, f"(c) MGR {label}") + hold_amgs(
        [("coarse AMG", m.amg), ("F-relax AMG", lv["famg"])], f"(c) MGR {label}")
    return out


def family_ams(dev, card):
    """(d) AMS-PCG on curlcurl_matrix(48^3)."""
    from hypre_tpu_torch.models import curlcurl_matrix
    from hypre_tpu_torch.ops.dia import kernel_launches
    from hypre_tpu_torch.solvers.amg.ams import AMS

    A, G, coords = curlcurl_matrix(48, 48, 48)
    zero_counts()
    t0 = time.perf_counter()
    a = AMS(A, G, coords, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    solve = lambda: a.solve(b, tol=1e-6, max_iter=200)  # noqa: E731
    res = solve()
    counts = read_counts()
    its = res.num_iterations
    calls = predicted_calls("pcg", {}, its)
    expected = expect([(kernel_launches(a._E), calls["A"]),
                       (a.apply_launches(), calls["M"])])
    ms = solve_median_ms(solve, reps=1)[0]
    want_its, want_g = AUX_AMS48
    g_space = a._amg_G is not None
    require(g_space == want_g, f"(d) AMS: G-space AMG built {g_space}, the "
                               f"JAX package's {want_g}")
    out = family_line("(d) AMS-PCG 48^3", card, its, want_its,
                      host_rel(A.to_scipy(), b, res.x), setup_s, ms, counts,
                      expected, edges=A.num_rows, g_space_built=g_space,
                      **busy(solve, its))
    out["held"] = hold_family_ops(
        [("A", a._E), ("G", a._G), ("G^T", a._GT), ("Pi", a._Pi),
         ("Pi^T", a._PiT)], "(d) AMS") + hold_amgs(
        [("G-space", a._amg_G), ("Pi-space", a._amg_Pi)], "(d) AMS")
    return out


def family_ads(dev, card):
    """(e) ADS-PCG on divdiv_matrix(13^3): 7,098 faces, 7,644 edges, so A,
    C, C^T, Pi and Pi^T and the curl-space AMS's operators run the
    ELL kernel (DENSE_MAX_ROWS 6,144)."""
    from hypre_tpu_torch.models import divdiv_matrix
    from hypre_tpu_torch.ops.dia import kernel_launches
    from hypre_tpu_torch.solvers.amg.ads import ADS

    A, C, Pi, G, coords = divdiv_matrix(13, 13, 13)
    zero_counts()
    t0 = time.perf_counter()
    d = ADS(A, C, Pi, G, coords, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    solve = lambda: d.solve(b, tol=1e-6, max_iter=200)  # noqa: E731
    res = solve()
    counts = read_counts()
    its = res.num_iterations
    calls = predicted_calls("pcg", {}, its)
    expected = expect([(kernel_launches(d._E), calls["A"]),
                       (d.apply_launches(), calls["M"])])
    ms = solve_median_ms(solve, reps=1)[0]
    out = family_line("(e) ADS-PCG 13^3", card, its, AUX_ADS13,
                      host_rel(A.to_scipy(), b, res.x), setup_s, ms, counts,
                      expected, faces=A.num_rows,
                      rt_space_levels=len(d._amg_Pi.levels))
    a = d._ams
    out["held"] = hold_family_ops(
        [("A", d._E), ("C", d._C), ("C^T", d._CT), ("Pi", d._Pi),
         ("Pi^T", d._PiT), ("curl-space A", a._E), ("curl-space G", a._G),
         ("curl-space G^T", a._GT), ("curl-space Pi", a._Pi),
         ("curl-space Pi^T", a._PiT)], "(e) ADS") + hold_amgs(
        [("curl-space G-space", a._amg_G), ("curl-space Pi-space", a._amg_Pi),
         ("RT nodal", d._amg_Pi)], "(e) ADS")
    return out


def ame_launches(e) -> dict:
    """AME.solve's launches from its own counts: the columns of A, M and
    AMS applied, and each projected column's matvecs and inner AMG-PCG
    (`inner_iterations`)."""
    from hypre_tpu_torch.ops.dia import kernel_launches as kl

    K0 = e._amg_K.levels[0].A
    parts = [(kl(e._E), e.applications["A"]), (kl(e._Em), e.applications["B"]),
             (e.ams.apply_launches(), e.applications["T"])]
    cols = len(e.inner_iterations)
    for op in (e._Em, e._GT, e._G):
        parts.append((kl(op), cols))
    for k in e.inner_iterations:
        calls = predicted_calls("pcg", {}, k)
        parts += [(kl(K0), calls["A"]), (e._amg_K.cycle_launches(), calls["M"])]
    return expect(parts)


def family_ame(dev, card):
    """(f) AME on curlcurl_matrix(16^3), M = I."""
    from hypre_tpu_torch.models import curlcurl_matrix
    from hypre_tpu_torch.ops.csr import CSRMatrix
    from hypre_tpu_torch.solvers.amg.ame import AME, AMEOptions

    A, G, coords = curlcurl_matrix(16, 16, 16)
    M = CSRMatrix.from_scipy(sp.eye(A.num_rows, format="csr"))
    zero_counts()
    t0 = time.perf_counter()
    e = AME(A, M, G, coords, AMEOptions(), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    res = []
    ms = solve_median_ms(lambda: res.append(e.solve()), reps=1)[0]
    res = res[0]
    counts = read_counts()
    evs = res.eigenvalues.cpu().numpy()
    want_its, want_evs = AUX_AME16
    ev_rel = float(np.abs(evs - np.asarray(want_evs)).max() / max(want_evs))
    out = family_line("(f) AME 16^3", card, res.num_iterations, want_its,
                      float(res.residual_norms.max()), setup_s, ms, counts,
                      ame_launches(e), eigenvalues=evs.tolist(),
                      eigenvalue_rel_to_jax=ev_rel, converged=res.converged,
                      columns=dict(e.applications),
                      projected_columns=len(e.inner_iterations))
    require(res.converged and ev_rel <= 1e-8,
            f"(f) AME: eigenvalues {evs} vs the JAX package's {want_evs}: "
            f"rel {ev_rel:.3e}")
    a = e.ams
    out["held"] = hold_family_ops(
        [("A", e._E), ("M", e._Em), ("G", e._G), ("G^T", e._GT),
         ("AMS Pi", a._Pi), ("AMS Pi^T", a._PiT)], "(f) AME") + hold_amgs(
        [("K", e._amg_K), ("AMS G-space", a._amg_G),
         ("AMS Pi-space", a._amg_Pi)], "(f) AME")
    return out


def hold_gathers(dd_dev, label, rng) -> int:
    """Every batched gather of the device cycle through its kernel
    (take_along_axis for float32, flat_take for float64) against the
    plain version on the same inputs, bitwise.  Returns the gathers held."""
    from hypre_tpu_torch.ops.gather_kernel import (
        flat_take_cuda, flat_take_reference, take_along_axis_cuda,
        take_along_axis_reference)

    n = 0
    for l, lv in enumerate(dd_dev.levels):
        for name in ("A", "R", "P"):
            B = lv.get(name)
            if B is None:
                continue
            D = B.cols.shape[0]
            u = torch.from_numpy(rng.standard_normal((D, B.ncols))).to(
                B.cols.device, dd_dev.dtype)
            if dd_dev.dtype == torch.float32:
                got = take_along_axis_cuda(u, B.cols, axis=1)
                want = take_along_axis_reference(u, B.cols, axis=1)
            else:
                got = flat_take_cuda(u.reshape(-1), B.flat)
                want = flat_take_reference(u.reshape(-1), B.flat)
            require(torch.equal(got, want),
                    f"{label} L{l} {name}: the gather differs from its plain "
                    f"version")
            n += 1
    return n


def time_dd_gathers(dd_dev, flush, card) -> dict:
    """The level-0 composite operator's gather (the cycle's largest),
    timed: the kernel in turns with its earlier launch (take_along_axis:
    one segment a whole idx row, the plan before `_long_row_span`;
    flat_take: the elementwise form), its plain version, the torch call,
    the bytes bound (x and the indices read once, the result written
    once)."""
    from hypre_tpu_torch.ops.gather_kernel import (
        flat_take_cuda, flat_take_reference, take_along_axis_cuda,
        take_along_axis_reference, take_plan)

    B = dd_dev.levels[0]["A"]
    D = B.cols.shape[0]
    u = torch.from_numpy(np.random.default_rng(53).standard_normal(
        (D, B.ncols))).to(B.cols.device, dd_dev.dtype)
    es = u.element_size()
    nbytes = u.numel() * es + B.cols.numel() * (4 + es)
    if dd_dev.dtype == torch.float32:
        name = "take_along_axis"
        fn = lambda: take_along_axis_cuda(u, B.cols, axis=1)  # noqa: E731
        whole = take_plan(u.shape, B.cols.shape, 1, span=B.cols.shape[1])
        old = lambda: take_along_axis_cuda(u, B.cols, axis=1,  # noqa: E731
                                           plan=whole)
        plain = lambda: take_along_axis_reference(u, B.cols, axis=1)  # noqa: E731
        cols64 = B.cols.long()
        lib = lambda: torch.take_along_dim(u, cols64, dim=1)  # noqa: E731
    else:
        name = "flat_take"
        uf = u.reshape(-1)
        fn = lambda: flat_take_cuda(uf, B.flat)  # noqa: E731
        old = lambda: flat_take_cuda(uf, B.flat,  # noqa: E731
                                     form="elementwise")
        plain = lambda: flat_take_reference(uf, B.flat)  # noqa: E731
        flat = B.flat.reshape(-1)
        lib = lambda: torch.index_select(uf, 0, flat)  # noqa: E731
    require(torch.equal(fn(), plain()) and torch.equal(old(), plain()),
            f"{name} at AMG-DD's level-0 shape differs from its plain version")
    ms, earlier_ms, _ = time_in_turns(fn, old, flush)
    plain_ms = time_cuda_ms(plain, flush)
    lib_ms = time_cuda_ms(lib, flush)
    bms, by = bound_ms(nbytes, 0, dd_dev.dtype)
    shape = {"x": [D, B.ncols], "idx": list(B.cols.shape)}
    log(f"{name} [AMG-DD level-0 gather {shape}, {dd_dev.dtype}; {card}]: "
        f"{ms * 1e3:.2f} us, in turns with the earlier launch "
        f"{earlier_ms * 1e3:.2f} us; plain {plain_ms * 1e3:.2f} us, torch "
        f"{lib_ms * 1e3:.2f} us, bound {bms * 1e3:.2f} us")
    return {"kernel": name, "shape": shape, "ms": ms, "earlier_ms": earlier_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by}


def family_amgdd(dev, card, flush, gathers):
    """(g) AMG-DD at 24^3: the host solve, then the device cycle in f64
    and f32 against the host cycle, its gathers held and timed (into
    `gathers`, by dtype)."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.solvers.amg import (AMGDD, AMGDDDevice, AMGDDOptions,
                                             BoomerAMG, BoomerAMGOptions)

    A = laplacian_7pt(24, 24, 24)
    t0 = time.perf_counter()
    amg = BoomerAMG(A, BoomerAMGOptions(**DD_AMG), device=dev)
    dd = AMGDD(amg, AMGDDOptions(num_domains=8, padding=2))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = dd.solve(np.ones(A.num_rows), tol=1e-8, max_iter=100)
    host_s = time.perf_counter() - t0
    log(f"family [(g) AMGDD.solve 24^3 (host numpy)]: {res.num_iterations} "
        f"iterations (JAX package: {AUX_DD24}), rel residual "
        f"{res.rel_residual_norm:.3e}; setup {setup_s:.2f} s (the composite "
        f"grids), solve {host_s:.2f} s; levels {len(dd.domains[0])}")
    require(res.converged and res.num_iterations == AUX_DD24,
            f"(g) AMGDD.solve: {res.num_iterations} iterations, the JAX "
            f"package's {AUX_DD24}")
    rng = np.random.default_rng(59)
    r = rng.standard_normal(A.num_rows)
    z_host = dd.cycle(r)
    out = {"solve": {"iterations": res.num_iterations,
                     "rel_residual": float(res.rel_residual_norm),
                     "setup_s": setup_s, "host_solve_s": host_s}}
    for dtype, tol in ((np.float64, 1e-10), (np.float32, 1e-5)):
        t0 = time.perf_counter()
        dv = AMGDDDevice(dd, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rt = torch.from_numpy(r).to(dev)
        zero_counts()
        z = dv.cycle(rt)
        torch.cuda.synchronize()
        counts = read_counts()
        expected = expect([(dv.cycle_launches(), 1)])
        rel = float(np.abs(z.double().cpu().numpy() - z_host).max()
                    / np.abs(z_host).max())
        label = f"(g) AMGDDDevice {np.dtype(dtype).name} 24^3"
        med, lo, hi = solve_median_ms(lambda: dv.cycle(rt))
        prof = busy(lambda: dv.cycle(rt))
        held = hold_gathers(dv, label, rng)
        log(f"family [{label}; {card}]: cycle vs the host cycle rel {rel:.3e} "
            f"(tol {tol:g}); build {build_s:.2f} s; cycle median of {MEDIAN_REPS} "
            f"{med:.3f} ms ({lo:.3f}-{hi:.3f}); under the profiler {prof}; "
            f"{held} gathers bitwise their plain versions; launches "
            f"{counts}, predicted {expected} ({dv.num_levels} levels, "
            f"num_relax {dd.opts.num_relax}, fac_cycles {dd.opts.fac_cycles})")
        require(rel <= tol, f"{label}: the cycle differs from the host cycle: "
                            f"rel {rel:.3e}")
        require(counts == expected, f"{label}: launches {counts} are not the "
                                    f"predicted {expected}")
        key = np.dtype(dtype).name
        out[key] = {"cycle_rel_to_host": rel, "build_s": build_s,
                    "cycle_median_ms": med, "cycle_min_max_ms": [lo, hi],
                    "gathers_held": held, "launches": counts, **prof}
        gathers[key] = time_dd_gathers(dv, flush, card)
    return out


def family_block(dev, card, interp):
    """(h) BlockAMG-PCG on sys_laplacian_7pt(24^3, 2)."""
    from hypre_tpu_torch.models import sys_laplacian_7pt
    from hypre_tpu_torch.ops.dia import freeze_auto, kernel_launches, spmv
    from hypre_tpu_torch.solvers.amg.block_amg import BlockAMG, BlockAMGOptions
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    A = sys_laplacian_7pt(24, 24, 24, 2)
    zero_counts()
    t0 = time.perf_counter()
    amg = BlockAMG(A, BlockAMGOptions(interp_type=interp), device=dev)
    E = freeze_auto(A, torch.float64, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
    solve = lambda: pcg(lambda x: spmv(E, x), b, M=amg.precond,  # noqa: E731
                        opts=PCGOptions(tol=1e-8, max_iter=100))
    res = solve()
    counts = read_counts()
    its = res.num_iterations
    # the block operators are plain torch (index_select + einsum): only
    # PCG's matvecs launch a kernel
    expected = expect([(kernel_launches(E), predicted_calls("pcg", {}, its)["A"])])
    ms = solve_median_ms(solve, reps=1)[0]
    out = family_line(f"(h) BlockAMG {interp} PCG 24^3", card, its,
                      AUX_BLOCK24[interp], host_rel(A.to_scipy(), b, res.x),
                      setup_s, ms, counts, expected, levels=len(amg.levels))
    require(res.converged, f"(h) BlockAMG {interp}: not converged")
    out["held"] = hold_family_ops([("A", E)], f"(h) BlockAMG {interp}")
    return out


def small_cases():
    """{label: build(device) -> (run() -> result, the quantity compared)}
    at 4^3-16^3, one for each solver of phase 16."""
    import hypre_tpu_torch.models as pm
    from hypre_tpu_torch.ops.csr import CSRMatrix
    from hypre_tpu_torch.ops.dia import freeze_auto, spmv
    from hypre_tpu_torch.solvers import krylov
    from hypre_tpu_torch.solvers.amg import (AMGDD, AMGDDDevice, AMGDDOptions,
                                             BoomerAMG, BoomerAMGOptions)
    from hypre_tpu_torch.solvers.amg import ads, ame, ams, block_amg, mgr, pilut
    from hypre_tpu_torch.solvers.amg import smoothed_aggregation as sa

    def krylov_on(A, dev, M, name="pcg", **kw):
        E = freeze_auto(A, torch.float64, dev)
        b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
        opts = getattr(krylov, {"pcg": "PCGOptions", "gmres": "GMRESOptions"}[
            name])(**kw)
        return lambda: getattr(krylov, name)(lambda x: spmv(E, x), b, M=M,
                                             opts=opts)

    def sa_case(dev):
        A = pm.laplacian_7pt(16, 16, 16)
        return krylov_on(A, dev, sa.SmoothedAggregationAMG(A, device=dev).precond,
                         tol=1e-6, max_iter=200)

    def pilut_case(dev):
        A = pm.laplacian_7pt(12, 12, 12)
        return krylov_on(A, dev, pilut.PILUT(A, device=dev).precond, "gmres",
                         tol=1e-8, max_iter=200, k_dim=30)

    def mgr_case(opts):
        def build(dev):
            A = pm.sys_laplacian_7pt(12, 12, 12, 2)
            m = mgr.MGR(A, np.arange(A.num_rows) % 2 == 1,
                        mgr.MGROptions(**opts), device=dev)
            b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
            return lambda: m.solve(A, b, tol=1e-8)
        return build

    def ams_case(dev):
        A, G, co = pm.curlcurl_matrix(12, 12, 12)
        a = ams.AMS(A, G, co, device=dev)
        b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
        return lambda: a.solve(b, tol=1e-6)

    def ads_case(dev):
        A, C, Pi, G, co = pm.divdiv_matrix(6, 6, 6)
        d = ads.ADS(A, C, Pi, G, co, device=dev)
        b = torch.ones(A.num_rows, dtype=torch.float64, device=dev)
        return lambda: d.solve(b, tol=1e-6)

    def ame_case(dev):
        A, G, co = pm.curlcurl_matrix(4, 4, 4)
        M = CSRMatrix.from_scipy(sp.eye(A.num_rows, format="csr"))
        return ame.AME(A, M, G, co, ame.AMEOptions(), device=dev).solve

    def dd_case(dev):
        A = pm.laplacian_7pt(12, 12, 12)
        amg = BoomerAMG(A, BoomerAMGOptions(**DD_AMG), device=dev)
        dv = AMGDDDevice(AMGDD(amg, AMGDDOptions(num_domains=8, padding=2)),
                         dtype=np.float64, device=dev)
        r = torch.from_numpy(np.random.default_rng(61).standard_normal(
            A.num_rows)).to(dev)
        return lambda: dv.cycle(r)

    def block_case(interp):
        def build(dev):
            A = pm.sys_laplacian_7pt(12, 12, 12, 2)
            amg = block_amg.BlockAMG(
                A, block_amg.BlockAMGOptions(interp_type=interp), device=dev)
            return krylov_on(A, dev, amg.precond, tol=1e-8, max_iter=100)
        return build

    return {"SA-PCG 16^3": sa_case, "PILUT-GMRES 12^3": pilut_case,
            "MGR default 12^3": mgr_case({}),
            "MGR blk_jacobi 12^3": mgr_case(MGR_BLK),
            "MGR injection 12^3": mgr_case({"interp_type": "injection"}),
            "AMS-PCG 12^3": ams_case,
            "ADS-PCG 6^3": ads_case, "AME 4^3": ame_case,
            "AMGDDDevice f64 cycle 12^3": dd_case,
            "BlockAMG direct 12^3": block_case("direct"),
            "BlockAMG classical 12^3": block_case("classical")}


# {label: (count slack, x tolerance)} where the card's count differs from
# the CPU's: block direct interpolation's level-1 P holds entries ~2e16
# at 12^3 x 2 (a near-singular block row sum, in both packages; ROADMAP
# Queue 3), so the cycle magnifies rounding ~3e9 and cuBLAS's and the
# CPU's orders of summation in the block products part: 13 iterations on
# the card, 14 on the CPU, x within 2.43e-8 (NVIDIA H100 80GB HBM3, 700 W)
FAMILY_SMALL_SLACK = {"BlockAMG direct 12^3": (1, 1e-6)}


def mgr_injection_card_vs_cpu(dev, card) -> dict:
    """MGR's injection W_p at 20^3 x 2: the all-zero 8,000 x 8,000 block
    (8,000 F rows, above DENSE_MAX_ROWS) frozen as a width-1 ELL.  The
    ELL kernel gives zeros, the level's operators hold against their
    plain versions, one application agrees with the CPU's within 1e-12."""
    from hypre_tpu_torch.models import sys_laplacian_7pt
    from hypre_tpu_torch.ops.csr import ELLMatrix
    from hypre_tpu_torch.ops.dia import spmv
    from hypre_tpu_torch.solvers.amg.mgr import MGR, MGROptions

    A = sys_laplacian_7pt(20, 20, 20, 2)
    cm = np.arange(A.num_rows) % 2 == 1
    m, mc = (MGR(A, cm, MGROptions(interp_type="injection"), device=d)
             for d in (dev, "cpu"))
    lv = m.levels[0]
    Wp = lv["Wp"]
    require(isinstance(Wp, ELLMatrix) and Wp.cols.shape[0] == 1,
            f"MGR injection 20^3: W_p is {describe(Wp)[0]} "
            f"{tuple(Wp.data.shape)}, not a width-1 ELL")
    rng = np.random.default_rng(67)
    x = torch.from_numpy(rng.standard_normal(Wp.num_cols)).to(dev)
    zero_counts()
    y = spmv(Wp, x)
    require(read_counts()["ell_spmv"] == 1 and not bool(y.any()),
            "MGR injection 20^3: W_p through the ELL kernel is not zero")
    held = hold_family_ops([(n, lv[n]) for n in ("Aff", "Acf", "Wp")],
                           "MGR injection 20^3")
    r = torch.from_numpy(rng.standard_normal(A.num_rows))
    want = mc.precond(r)
    rel = float((m.precond(r.to(dev)).cpu() - want).abs().max()
                / want.abs().max())
    log(f"MGR injection 20^3 [{card}]: W_p a width-1 ELL of {Wp.num_rows} "
        f"rows gives zeros through the ELL kernel; one application card vs "
        f"CPU rel {rel:.2e}")
    require(rel <= 1e-12, f"MGR injection 20^3: the card's application "
                          f"differs from the CPU's, rel {rel:.3e}")
    return {"application_rel": rel, "held": held}


def family_card_vs_cpu(dev, card) -> dict:
    """Every phase-16 solver at 4^3-16^3 on the card and on the CPU: the
    same count, x (AME: the eigenvalues; AMG-DD: the device cycle) within
    1e-10, but FAMILY_SMALL_SLACK's line."""
    out = {}
    for label, build in small_cases().items():
        got, secs = [], []
        for device in (dev, "cpu"):
            t0 = time.perf_counter()
            res = build(device)()
            secs.append(time.perf_counter() - t0)
            if torch.is_tensor(res):
                got.append((None, res.cpu()))
            elif hasattr(res, "eigenvalues"):
                got.append((res.num_iterations, res.eigenvalues.cpu()))
            else:
                got.append((res.num_iterations, res.x.cpu()))
        require_no_gs_fault(dev, f"family card vs CPU {label}")
        (its_g, v_g), (its_c, v_c) = got
        rel = float((v_g - v_c).abs().max() / v_c.abs().max())
        slack, tol = FAMILY_SMALL_SLACK.get(label, (0, 1e-10))
        log(f"family card vs CPU [{label}; {card}]: iterations {its_g} vs "
            f"{its_c}, max rel diff {rel:.2e} (slack {slack}, tol {tol:g}); "
            f"build and run: card {secs[0]:.2f} s, CPU {secs[1]:.2f} s")
        require((its_g == its_c if its_g is None else
                 abs(its_g - its_c) <= slack) and rel <= tol,
                f"family {label}: the card ({its_g}) and the CPU ({its_c}) "
                f"differ, rel {rel:.3e}")
        out[label] = {"iterations": its_g, "max_rel_diff": rel,
                      "card_s": secs[0], "cpu_s": secs[1]}
    return out


def phase_family(dev, card):
    """Phase 16: the AMG family (module docstring)."""
    t0 = time.perf_counter()
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    runs = {}

    def line(key, fn, *args):
        """runs[key] = fn(dev, card, *args) with its wall seconds."""
        t = time.perf_counter()
        runs[key] = fn(dev, card, *args)
        runs[key]["wall_s"] = time.perf_counter() - t
        log(f"family {key}: {runs[key]['wall_s']:.1f} s")
        torch.cuda.empty_cache()

    line("(a) SA 96", family_sa)
    line("(b) PILUT 48", family_pilut)
    for label in AUX_MGR48:
        line(f"(c) MGR {label} 48", family_mgr, label)
    line("(d) AMS 48", family_ams)
    line("(e) ADS 13", family_ads)
    line("(f) AME 16", family_ame)
    dd_gathers = {}
    line("(g) AMG-DD 24", lambda d, c: family_amgdd(d, c, flush, dd_gathers))
    for interp in AUX_BLOCK24:
        line(f"(h) BlockAMG {interp} 24", family_block, interp)
    del flush
    torch.cuda.empty_cache()
    t = time.perf_counter()
    small = family_card_vs_cpu(dev, card)
    small["MGR injection W_p 20^3"] = mgr_injection_card_vs_cpu(dev, card)
    log(f"family card vs CPU: {time.perf_counter() - t:.1f} s")
    require_no_gs_fault(dev, "phase 16")
    total = {name: 0 for name in read_counts()}
    for k, v in runs.items():
        launches = (v["launches"] if "launches" in v else
                    {n: v["float64"]["launches"][n] + v["float32"]["launches"][n]
                     for n in total})
        for name in total:
            total[name] += launches[name]
    log(f"family launches, lines (a)-(h): {total}")
    log(f"the AMG family phase took {time.perf_counter() - t0:.1f} s")
    return runs, small, total, dd_gathers


# -- 17. the struct interface ------------------------------------------------

# phase 20's serial lines, whose (A, solver) phase 17 keeps: phase 20
# label -> phase 17 label (the same driver line)
PS_KEPT = {"(a) PFMG": "(a)", "(b) PFMG -c 2 3 40": "(c)"}

# label -> (struct driver line, the JAX driver's count on the CPU; slow
# test tests/test_torch_struct_driver.py::test_jax_count_is_the_chip_pin)
STRUCT_JAX = {
    "(a)": ("-n 96 96 96 -solver 1", 17),
    "(b)": ("-n 96 96 96 -solver 11", 9),
    "(c)": ("-n 96 96 96 -c 2.0 3.0 40 -solver 1", 13),
    "(d) SMG": ("-n 48 48 48 -solver 0", 6),
    "(d) SMG-PCG": ("-n 48 48 48 -solver 10", 5),
    "(e)": ("-n 32 32 32 -solver 2", 13),
}
STRUCT24 = (8, 17, 18, 19, 25, 30, 31, 38, 39)  # (f): -n 24 24 24, card vs CPU
# (g): the struct jobs of tests/test_regression_drivers.py:103-139 (line,
# [REF] count, residual or None); tests/test_torch_struct_driver.py
# replays them on the CPU
STRUCT_REF = (
    # [REF] TEST_struct/smgbase2d.saved
    ("-n 12 12 1 -d 2 -solver 0", 5, 2.468039e-07),
    # [REF] TEST_struct/smgbase3d.saved
    ("-n 12 12 12 -c 2.0 3.0 40 -solver 0", 4, 8.971901e-07),
    # [REF] TEST_struct/pfmgbase3d.saved (iterations)
    ("-n 12 12 12 -c 2.0 3.0 40 -solver 1", 10, None),
    # [REF] TEST_struct/cgpfmg3d.saved (iterations)
    ("-n 12 12 12 -solver 11 -skip 1", 9, None),
    # [REF] TEST_struct/solvers.saved: SMG-PCG
    ("-solver 10", 4, None),
    # [REF] TEST_struct/solvers.saved: unpreconditioned PCG
    ("-solver 19", 20, 5.962015e-07),
    # [REF] TEST_struct/solvers.saved: DS-PCG
    ("-solver 18", 20, 5.962015e-07),
    # [REF~] TEST_struct/pfmgbase2d.saved says 13; the JAX package's 11
    ("-n 12 12 1 -d 2 -solver 1 -relax 1", 11, None),
    # [REF~] TEST_struct/solvers.saved says 8; the JAX package's 7
    ("-solver 11", 7, None),
    # [REF~] TEST_struct/solvers.saved says 20 for solver 17; the JAX
    # package's literal two-sweep Jacobi preconditioner: 11
    ("-solver 17", 11, None),
)
# (h): multi-box lines and the JAX driver's counts
STRUCT_MULTIBOX = {"-n 12 12 12 -P 2 1 2 -b 1 1 1 -solver 1": 16,
                   "-n 24 24 1 -d 2 -P 2 2 1 -solver 1": 15}
EX1_ITERS = 11  # (i): examples/ex1.py's PFMG through the JAX package
STRUCT_PHASES = ("STRUCT_SETUP", "STRUCT_INTERP", "STRUCT_RAP",
                 "STRUCT_FREEZE", "SMG_PLANES")
# the solve's median of MEDIAN_REPS, but one timed solve where a solve is
# seconds of host-bound launches (~150,000 kernels: SMG 48^3, SparseMSG
# 32^3)
STRUCT_REPS = {"(d) SMG": 1, "(d) SMG-PCG": 1, "(e)": 1}


def drive_struct(line: str, device):
    """The port's struct driver on one line, its printout captured and
    logged.  Returns (result, wall seconds)."""
    import contextlib
    import io

    from hypre_tpu_torch.drivers import struct as driver

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = driver.run(line.split(), device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for ln in buf.getvalue().splitlines():
        log(f"  struct [{torch.device(device).type}] {ln}")
    return res, wall


def struct_true_residual(A, x, b, tol: float):
    """(||b - A x|| / ||b|| in float64 through struct_matvec, the bound
    it must meet: tol + 4 eps ||A||_inf ||x|| / ||b||), finite x."""
    from hypre_tpu_torch.struct import struct_matvec

    require(bool(torch.isfinite(x).all()), "non-finite solution")
    r = b - struct_matvec(A, x)
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(r)) / nb
    norm_inf = float(A.data.abs().sum(0).max()) + sum(abs(v) for v in A.const_values)
    bound = tol + 4 * torch.finfo(x.dtype).eps * norm_inf * float(
        torch.linalg.vector_norm(x)) / nb
    return rel, bound


def struct_solve(res, line: str):
    """(solve(), cycle()) -> the line's solve again on the objects the
    driver built (b = ones, the driver's tolerance), and one application
    of its multigrid cycle (the preconditioner of the PCG lines)."""
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
    from hypre_tpu_torch.struct import struct_matvec

    sid = int(line.split("-solver")[1].split()[0])
    A, s = res.A, res.solver
    b = torch.ones(A.shape, dtype=torch.float64, device=A.device)
    cycle = (lambda: s.cycle(b))
    if sid in (10, 11):
        return (lambda: pcg(lambda x: struct_matvec(A, x), b, M=s.precond,
                            opts=PCGOptions(tol=1e-6, max_iter=200,
                                            two_norm=True))), cycle
    return (lambda: s.solve(b)), cycle


def struct_line(label, dev, card, kept=None) -> dict:
    """One of (a)-(e): the JAX package's count, setup by phase, the
    solve's median of 5 and one profiled cycle, the true residual, the
    kernels' launches (K1 / ELL on SparseMSG's frozen transfers exactly
    as `kernel_launches` says, none elsewhere); for (e) each transfer
    held against its plain version and one cycle against the CPU's.
    The seconds of each step are kept; `kept[label]` = (A, solver) of
    the line, where `kept` is given (phase 20 cuts them to its mesh)."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    line, want = STRUCT_JAX[label]
    GLOBAL_TIMER.clear()
    zero_counts()
    res, wall = drive_struct(line, dev)
    counts = read_counts()
    if kept is not None:
        kept[label] = (res.A, res.solver)
    its = int(res.num_iterations)
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in STRUCT_PHASES
              if GLOBAL_TIMER.seconds(k)}
    b = torch.ones(res.A.shape, dtype=torch.float64, device=dev)
    rel, bound = struct_true_residual(res.A, res.x, b, 1e-6)
    require(res.converged and its == want,
            f"struct {label}: {its} iterations, the JAX package's {want}")
    require(rel < bound, f"struct {label}: true residual {rel:.3e} above "
                         f"{bound:.3e}")
    if label == "(e)":
        per = res.solver.cycle_launches()
        expected = {n: per.get(n, 0) * its for n in counts}
        expected["dia_spmv_tail"] = 0
        require(expected["ell_spmv"] > 0, "SparseMSG froze no ELL transfer")
    else:
        expected = {n: 0 for n in counts}
    require(counts == expected, f"struct {label}: launches {counts}, "
                                f"expected {expected}")
    seconds = {"driver": wall}
    solve, cycle = struct_solve(res, line)
    reps = STRUCT_REPS.get(label, MEDIAN_REPS)
    t = time.perf_counter()
    med, lo, hi = solve_median_ms(solve, reps)
    seconds["solves"] = time.perf_counter() - t
    # one cycle under the profiler, the device activity alone (a whole
    # solve's 10^4-10^5 kernels take the profiler a minute to collect)
    t = time.perf_counter()
    prof = busy(cycle, 1, cpu=False)
    seconds["profile"] = time.perf_counter() - t
    prof = {"cycle_wall_ms": prof["wall_ms"], "cycle_busy_ms": prof["busy_ms"],
            "idle_share": prof["idle_share"],
            "kernels_per_cycle": prof["kernels_per_iteration"]}
    out = {"line": line, "iterations": its, "jax_iterations": want,
           "true_rel_residual": rel, "bound": bound,
           "driver_wall_s": wall, "setup_phases_s": phases,
           "solve_median_ms": med, "solve_reps": reps,
           "solve_min_max_ms": [lo, hi], **prof, "launches": counts}
    full = ""
    if label == "(a)":
        # the device-only profile against the full one on the same cycle
        t = time.perf_counter()
        out["kernels_per_cycle_full_profile"] = busy(
            cycle, 1, cpu=True)["kernels_per_iteration"]
        seconds["profile, CPU activity too"] = time.perf_counter() - t
        full = (f" ({out['kernels_per_cycle_full_profile']:.0f} with the CPU "
                f"activity recorded too)")
    if label == "(e)":
        t = time.perf_counter()
        out["held"] = hold_msg_transfers(res.solver, dev)
        out["cycle_vs_cpu"] = msg_cycle_vs_cpu(res.solver, res.A, b)
        seconds["held, cycle vs CPU"] = time.perf_counter() - t
    out["seconds"] = seconds
    log(f"struct {label} [{card}] {line}: {its} iterations (JAX {want}), "
        f"true rel residual {rel:.3e}; setup {phases}; solve median of "
        f"{reps} {med:.2f} ms ({lo:.2f}-{hi:.2f}); one cycle: wall "
        f"{prof['cycle_wall_ms']:.2f} ms, busy {prof['cycle_busy_ms']:.2f} ms, "
        f"idle {prof['idle_share']:.1%}, {prof['kernels_per_cycle']:.0f} "
        f"kernels{full}; launches { {k: v for k, v in counts.items() if v} }; "
        f"seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return out


def hold_msg_transfers(solver, dev) -> dict:
    """`hold_ops` on every transfer a SparseMSG froze: each R (fine rows
    in, coarse rows out) and each P, in the plain form the cycle runs,
    f64 within 1e-12 of the plain version, at the shapes of the line."""
    ops = []
    for key, (P, _) in solver.Pmat.items():
        nf, nc = P.shape
        ops.append((f"R {key}", solver.Rdev[key], nf, nc, ("plain",)))
        ops.append((f"P {key}", solver.Pdev[key], nc, nf, ("plain",)))
    return hold_ops(ops, 1e-12, "struct (e) transfers",
                    np.random.default_rng(41), torch.float64, dev)


def msg_cycle_vs_cpu(solver, A, b) -> dict:
    """One SparseMSG cycle of the line on the card against the same
    cycle of a CPU instance on the same matrix, from zero and from a
    random guess: within 1e-12 of the largest entry."""
    from hypre_tpu_torch.solvers.struct_ls import SparseMSG

    host = SparseMSG(A.to("cpu"), solver.opts, device="cpu")
    u = torch.from_numpy(np.random.default_rng(43).standard_normal(
        tuple(A.shape)))
    worst = 0.0
    for guess in (None, u):
        want = host.cycle(b.cpu(), guess)
        got = solver.cycle(b, None if guess is None else guess.to(b.device))
        worst = max(worst, float((got.cpu() - want).abs().max()
                                 / want.abs().max()))
    require(worst <= 1e-12, f"struct (e): a cycle on the card is {worst:.2e} "
                            f"from the CPU's")
    log(f"struct (e): every transfer held; one cycle on the card vs the "
        f"CPU, from zero and from a guess: max rel {worst:.2e} (tol 1e-12)")
    return {"max_rel": worst}


def struct_card_vs_cpu(line: str, card) -> dict:
    """(f): the line on the card and on the CPU, the same count, x
    within 1e-12 of max |x|."""
    rc, wc = drive_struct(line, torch.device("cuda", 0))
    rh, wh = drive_struct(line, "cpu")
    dx = float((rc.x.cpu() - rh.x).abs().max() / rh.x.abs().max())
    log(f"struct 24^3 [{card}] {line}: card {rc.num_iterations} / CPU "
        f"{rh.num_iterations} iterations, max rel diff of x {dx:.2e}")
    require(rc.num_iterations == rh.num_iterations and dx <= 1e-12,
            f"struct {line}: card and CPU differ")
    return {"iterations": int(rc.num_iterations), "dx": dx, "card_s": wc,
            "cpu_s": wh}


def struct_matvec_case(dev, flush, card) -> dict:
    """(j): struct_matvec at 96^3 alone, timed (L2 flushed) beside its
    bytes bound, with the kernels a call ran (`busy`): a variable
    7-point stencil as a driver builds it (grid slices), the same boxed
    as a solver freezes a level (flat runs), a constant-coefficient
    stencil, and the boxed data as a 7-offset DIA matrix through K1;
    each held against K1's plain version on the DIA form.  It runs
    before any other profile: after long profiles the profiler can miss
    a few of a profile's events (all of a call's 8; phase 17 (a) logs
    its cycle's count in both profile modes), which K1's wrapper count
    shows beside its profile."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
    from hypre_tpu_torch.struct import StructGrid, StructMatrix, struct_matvec

    shape = (NX, NX, NX)
    n = NX**3
    rng = np.random.default_rng(17)
    offs = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
            (0, 0, -1), (0, 0, 1)]
    ent = {o: (6.0 if o == (0, 0, 0) else -1.0) * (1 + 0.1 * rng.random(shape))
           for o in offs}
    A = StructMatrix.from_dict(ent, StructGrid(shape), device=dev)
    Ab = A.boxed()
    C = StructMatrix.from_dict({o: (6.0 if o == (0, 0, 0) else -1.0)
                                for o in offs}, StructGrid(shape), device=dev)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dev)
    # the DIA form: data[k, i] = A[i, i + flat(o_k)], 0 where i + o_k
    # leaves the box (the boxed data), the offsets ascending
    flat = [o[0] * NX * NX + o[1] * NX + o[2] for o in A.offsets]
    order = np.argsort(flat)
    data = Ab.data.reshape(len(flat), n)[torch.from_numpy(order).to(dev)].contiguous()
    dia_offs = tuple(int(flat[k]) for k in order)
    y_p = dia_spmv_reference(data, dia_offs, x.reshape(-1))
    scale = float(y_p.abs().max())
    err = {name: float((y.reshape(-1) - y_p).abs().max()) / scale
           for name, y in (("grid slices", struct_matvec(A, x)),
                           ("flat runs", struct_matvec(Ab, x)),
                           ("K1", dia_spmv_cuda(data, dia_offs, x.reshape(-1))))}
    log(f"struct_matvec 96^3 vs K1's plain version on the DIA form (rel, "
        f"tol 1e-12): {err}")
    require(max(err.values()) <= 1e-12,
            "struct_matvec and K1 disagree on the 7-point stencil")
    yc = struct_matvec(C, x)
    yv = struct_matvec(StructMatrix.from_dict(
        {o: v * np.ones(shape) for o, v in zip(C.const_offsets, C.const_values)},
        StructGrid(shape), device=dev), x)
    err["constant"] = float((yc - yv).abs().max() / yv.abs().max())
    require(err["constant"] <= 1e-12, "constant-coefficient struct_matvec disagrees")

    out = {}
    for name, fn, nbytes in (
            ("variable, grid slices", lambda: struct_matvec(A, x), 9 * n * 8),
            ("variable, boxed: flat runs", lambda: struct_matvec(Ab, x), 9 * n * 8),
            ("constant", lambda: struct_matvec(C, x), 2 * n * 8),
            ("K1 on the DIA form", lambda: dia_spmv_cuda(
                data, dia_offs, x.reshape(-1)), 9 * n * 8)):
        ms = time_cuda_ms(fn, flush)
        bms, by = bound_ms(nbytes, 13 * n, torch.float64)
        before = dia_spmv_cuda.launches
        k = busy(fn, 1, cpu=True)["kernels_per_iteration"]
        out[name] = {"ms": ms, "bound_ms": bms, "bound_by": by,
                     "bytes": nbytes, "kernels": k,
                     "k1_launches": dia_spmv_cuda.launches - before}
        log(f"struct_matvec (j) [{name}; {card}], L2 flushed, median of "
            f"{REPS}: {ms * 1e3:.1f} us, {k:.0f} kernels a call by the "
            f"profiler (K1's wrapper: {out[name]['k1_launches']}), "
            f"{nbytes / 1e6:.1f} MB, bound {bms * 1e3:.1f} us ({by})")
    out["max_rel_err"] = err
    return out


def phase_struct(dev, card, matvec):
    """Phase 17: the struct interface (module docstring); `matvec` is
    (j), `struct_matvec_case`, run before the other phases."""
    from hypre_tpu_torch.solvers.struct_ls import PFMG, PFMGOptions
    from hypre_tpu_torch.struct import StructGrid, StructMatrix

    t0 = time.perf_counter()
    runs, kept = {}, {}
    for label in STRUCT_JAX:
        t = time.perf_counter()
        runs[label] = struct_line(label, dev, card,
                                  kept if label in PS_KEPT.values() else None)
        runs[label]["wall_s"] = time.perf_counter() - t
        log(f"struct {label}: {runs[label]['wall_s']:.1f} s")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    small = {sid: struct_card_vs_cpu(f"-n 24 24 24 -solver {sid}", card)
             for sid in STRUCT24}
    log(f"struct (f) card vs CPU: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ref = {}
    for line, want, rel_pin in STRUCT_REF:
        res, _ = drive_struct(line, dev)
        rel = float(res.rel_residual_norm)
        require(res.converged and res.num_iterations == want,
                f"struct [REF] {line}: {res.num_iterations}, pinned {want}")
        require(rel_pin is None or abs(rel - rel_pin) < 2e-9,
                f"struct [REF] {line}: residual {rel:.6e}, pinned {rel_pin}")
        ref[line] = {"iterations": int(res.num_iterations), "rel": rel}
    log(f"struct (g) the [REF] / [REF~] lines on the card, all held: "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    multibox = {}
    for line, want in STRUCT_MULTIBOX.items():
        res, wall = drive_struct(line, dev)
        require(res.matvec_err is not None and res.matvec_err <= 1e-12,
                f"struct {line}: multi-box matvec off by {res.matvec_err}")
        require(res.converged and res.num_iterations == want,
                f"struct {line}: {res.num_iterations}, the JAX package's {want}")
        multibox[line] = {"iterations": int(res.num_iterations),
                          "matvec_max_abs_err": res.matvec_err, "wall_s": wall}
        log(f"struct (h) [{card}] {line}: multi-box matvec vs canonical "
            f"{res.matvec_err:.2e}, {res.num_iterations} iterations (JAX {want})")
    # (i) examples/ex1.py's problem through the port's API
    shape = (32, 32)
    ones = np.ones(shape)
    A = StructMatrix.from_dict({(0, 0): 4.0 * ones, (-1, 0): -ones,
                                (1, 0): -ones, (0, -1): -ones, (0, 1): -ones},
                               StructGrid(shape), device=dev)
    res = PFMG(A, PFMGOptions(tol=1e-6, skip_relax=0)).solve(
        torch.ones(shape, dtype=torch.float64, device=dev))
    require(res.converged and res.num_iterations == EX1_ITERS,
            f"ex1: {res.num_iterations} iterations, the JAX package's {EX1_ITERS}")
    ex1 = {"iterations": res.num_iterations,
           "rel": float(res.rel_residual_norm)}
    log(f"struct (i) ex1 32x32 PFMG [{card}]: {ex1}")
    log(f"struct (h), (i): {time.perf_counter() - t:.1f} s")
    total = {name: sum(v["launches"][name] for v in runs.values())
             for name in read_counts()}
    log(f"struct launches, lines (a)-(e): {total}")
    log(f"the struct phase took {time.perf_counter() - t0:.1f} s")
    return {"lines": runs, "card_vs_cpu_24": small, "ref": ref,
            "multibox": multibox, "ex1": ex1, "matvec": matvec}, total, kept


# -- 18. the sstruct interface -----------------------------------------------

# label -> (sstruct driver line, the JAX driver's count on the CPU; slow
# test tests/test_torch_sstruct_driver.py::test_jax_count_is_the_chip_pin).
# 48^3 a part: the largest size at which the JAX package's Split loop
# (one lax.while_loop with every level a constant) is run on a CPU here
SSTRUCT_JAX = {
    "(a)": ("-n 48 48 48 -solver 11", 24),
    "(b)": ("-n 48 48 48 -solver 1", 200),  # max_iter, unconverged
    "(c)": ("-n 48 48 48 -solver 3", 18),
    "(d)": ("-n 48 48 48 -solver 18", 160),
}
# the 48^3 lines the card runs too; (b)'s 200 Split iterations (~15 s)
# are held on the CPU only (the slow test runs the port there as well)
SSTRUCT_JAX_CARD = ("(a)", "(c)", "(d)")
# label -> (the 96^3 line, the port's count on a CPU: `python -m
# hypre_tpu_torch.drivers.sstruct <line> --device cpu`); (b) at 48^3,
# the JAX package's count (SSTRUCT_JAX; the port's CPU count is the
# same), since phase 19 came: at 96^3 its 200 unconverged Split steps
# took 12.6-17.1 s a solve and its setup ~12 s (NVIDIA H100 80GB HBM3,
# 700 W)
SSTRUCT96 = {
    "(a)": ("-n 96 96 96 -solver 11", 33),
    "(b)": ("-n 48 48 48 -solver 1", 200),  # max_iter, unconverged
    "(c)": ("-n 96 96 96 -solver 3", 18),
    "(d)": ("-n 96 96 96 -solver 18", 200),  # max_iter, unconverged
}
# (e): card vs CPU at 24^3 a part; the Split-SMG lines (0, 10) at 12^3:
# at 24^3 an SMG cycle is ~0.25 s of host-bound launches on the card and
# as long on the CPU (-solver 0: 79 iterations, two cycles each; 10: 26
# preconditioner applications, ~27 s card and CPU together)
SSTRUCT24 = {0: 12, 8: 24, 10: 12, 13: 24, 19: 24}
SSTRUCT_IN_IDS = (18, 20, 11)  # (f): every text; FAC-AMR 99 on FacParts texts
SSTRUCT_FAC_ID = 99
# solves timed again after the driver's own, on what it built
# (`res.resolve`), for the median: 5 where a solve is under a second; 0
# (the driver's one solve) where it is seconds of host-bound launches
# ((a) 2-3 s, (c) ~1 s, (b)'s 200 Split iterations ~14 s on the NVIDIA
# H100 80GB HBM3 at 700 W; (a) and (c) were timed again once until phase
# 20 came, 3 times until phase 19), as the script's 1,200 s leave no
# room for more
SSTRUCT_REPS = {"(a)": 0, "(b)": 0, "(c)": 0, "(d)": 5}
SSTRUCT_MAX_ITER = 200  # the driver's default; (b) and (d) stop there
# lines whose whole solve is profiled (kernels and busy per iteration =
# the solve's / its count): a DS-PCG iteration is ~18 kernels, and a
# profile that short late in the script can read none (run 4)
SSTRUCT_PROFILE_SOLVE = ("(d)",)
# (f): the grid-spec texts; tests/test_torch_sstruct_infile.py builds its
# corpus from them.  Each refinement (-r) a text runs at here; cell_node's
# composite is the largest, 135,265 unknowns
SSTRUCT_INFILE_R = {"neighbor": "-r 2 2 2", "cell_node": "-r 8 8 8",
                    "fac": ""}
SSTRUCT_INFILES = {

    # two cell-centred parts side by side along x: the stencil legs that
    # leave a part through its x face land on the other part through
    # GridSetNeighborPart; part 0's diagonal set to 7 on every other
    # cell of its lower half, part 1's raised by 0.5 (the index of the
    # AddTo box written with an explicit zero shift)
    "neighbor": """\
GridCreate: 3 2
GridSetExtents: 0 (1- 1- 1-) (6+ 6+ 6+)
GridSetExtents: 1 (1- 1- 1-) (6+ 6+ 6+)
GridSetVariables: 0 1 [0]
GridSetVariables: 1 1 [0]
GridSetPeriodic: 0 [0 0 0]
GridSetNeighborPart: 0 (7- 1- 1-) (7- 6+ 6+) 1 (1- 1- 1-) (1- 6+ 6+) [0 1 2] [1 1 1]
GridSetNeighborPart: 1 (0+ 1- 1-) (0+ 6+ 6+) 0 (6+ 1- 1-) (6+ 6+ 6+) [0 1 2] [1 1 1]
StencilCreate: 0 7
StencilSetEntry: 0 0 [0 0 0] 0 6.0
StencilSetEntry: 0 1 [-1 0 0] 0 -1.0
StencilSetEntry: 0 2 [1 0 0] 0 -1.0
StencilSetEntry: 0 3 [0 -1 0] 0 -1.0
StencilSetEntry: 0 4 [0 1 0] 0 -1.0
StencilSetEntry: 0 5 [0 0 -1] 0 -1.0
StencilSetEntry: 0 6 [0 0 1] 0 -1.0
GraphSetStencil: 0 0 0
GraphSetStencil: 1 0 0
MatrixSetValues: 0 (1- 1- 1-) (6+ 6+ 3+) [2 1 1] 0 0 7.0
MatrixAddToValues: 1 (1- 1- 1- : 0 0 0) (6+ 6+ 6+ : 0 0 0) [1 1 1] 0 0 0.5
""",
    # two parts of two variables each: part 0 CELL + NODE, part 1 CELL +
    # XFACE; each variable's 7-point stencil, and legs from the cells to
    # the other variable (and back) that join boxes of different shapes
    # (they assemble into U); the parts' cells couple across x through
    # GraphAddEntries
    "cell_node": """\
GridCreate: 3 2
GridSetExtents: 0 (1- 1- 1-) (4+ 4+ 4+)
GridSetExtents: 1 (1- 1- 1-) (4+ 4+ 4+)
GridSetVariables: 0 2 [0 1]
GridSetVariables: 1 2 [0 2]
GridSetPeriodic: 1 [0 0 0]
StencilCreate: 0 9
StencilSetEntry: 0 0 [0 0 0] 0 7.0
StencilSetEntry: 0 1 [-1 0 0] 0 -1.0
StencilSetEntry: 0 2 [1 0 0] 0 -1.0
StencilSetEntry: 0 3 [0 -1 0] 0 -1.0
StencilSetEntry: 0 4 [0 1 0] 0 -1.0
StencilSetEntry: 0 5 [0 0 -1] 0 -1.0
StencilSetEntry: 0 6 [0 0 1] 0 -1.0
StencilSetEntry: 0 7 [0 0 0] 1 -0.25
StencilSetEntry: 0 8 [-1 -1 -1] 1 -0.25
StencilCreate: 1 9
StencilSetEntry: 1 0 [0 0 0] 1 7.0
StencilSetEntry: 1 1 [-1 0 0] 1 -1.0
StencilSetEntry: 1 2 [1 0 0] 1 -1.0
StencilSetEntry: 1 3 [0 -1 0] 1 -1.0
StencilSetEntry: 1 4 [0 1 0] 1 -1.0
StencilSetEntry: 1 5 [0 0 -1] 1 -1.0
StencilSetEntry: 1 6 [0 0 1] 1 -1.0
StencilSetEntry: 1 7 [0 0 0] 0 -0.25
StencilSetEntry: 1 8 [1 1 1] 0 -0.25
StencilCreate: 2 9
StencilSetEntry: 2 0 [0 0 0] 0 7.0
StencilSetEntry: 2 1 [-1 0 0] 0 -1.0
StencilSetEntry: 2 2 [1 0 0] 0 -1.0
StencilSetEntry: 2 3 [0 -1 0] 0 -1.0
StencilSetEntry: 2 4 [0 1 0] 0 -1.0
StencilSetEntry: 2 5 [0 0 -1] 0 -1.0
StencilSetEntry: 2 6 [0 0 1] 0 -1.0
StencilSetEntry: 2 7 [0 0 0] 1 -0.25
StencilSetEntry: 2 8 [-1 0 0] 1 -0.25
StencilCreate: 3 9
StencilSetEntry: 3 0 [0 0 0] 1 7.0
StencilSetEntry: 3 1 [-1 0 0] 1 -1.0
StencilSetEntry: 3 2 [1 0 0] 1 -1.0
StencilSetEntry: 3 3 [0 -1 0] 1 -1.0
StencilSetEntry: 3 4 [0 1 0] 1 -1.0
StencilSetEntry: 3 5 [0 0 -1] 1 -1.0
StencilSetEntry: 3 6 [0 0 1] 1 -1.0
StencilSetEntry: 3 7 [0 0 0] 0 -0.25
StencilSetEntry: 3 8 [1 0 0] 0 -0.25
GraphSetStencil: 0 0 0
GraphSetStencil: 0 1 1
GraphSetStencil: 1 0 2
GraphSetStencil: 1 1 3
GraphAddEntries: 0 (4+ 1- 1-) (4+ 4+ 4+) [1 1 1] 0 1 (1- 1- 1-) (1- 4+ 4+) [1 1 1] 0 [0 1 2] 9 -1.0
GraphAddEntries: 1 (1- 1- 1-) (1- 4+ 4+) [1 1 1] 0 0 (4+ 1- 1-) (4+ 4+ 4+) [1 1 1] 0 [0 1 2] 9 -1.0
MatrixAddToValues: 0 (1- 1- 1-) (4+ 4+ 4+) [1 1 1] 1 0 0.5
""",
    # a two-level AMR composite in 2-D (FacParts): part 0 the coarse
    # 16 x 16 cells, part 1 a factor-2 patch over coarse cells 4..11;
    # each coarse cell beside the patch couples to its two facing fine
    # cells, and each fine boundary cell to its parent's neighbour
    # (GraphAddEntries with strides), all with -0.5
    "fac": """\
GridCreate: 2 2
GridSetExtents: 0 (0- 0-) (15+ 15+)
GridSetExtents: 1 (8- 8-) (23+ 23+)
GridSetVariables: 0 1 [0]
GridSetVariables: 1 1 [0]
StencilCreate: 0 5
StencilSetEntry: 0 0 [0 0] 0 5.0
StencilSetEntry: 0 1 [-1 0] 0 -1.0
StencilSetEntry: 0 2 [1 0] 0 -1.0
StencilSetEntry: 0 3 [0 -1] 0 -1.0
StencilSetEntry: 0 4 [0 1] 0 -1.0
GraphSetStencil: 0 0 0
GraphSetStencil: 1 0 0
FacParts: 0 0 [1 1]
FacParts: 1 1 [2 2]
GraphAddEntries: 1 (8- 8-) (8- 22-) [1 2] 0 0 (3- 4-) (3- 11-) [1 1] 0 [0 1] 5 -0.5
GraphAddEntries: 1 (8- 9-) (8- 23-) [1 2] 0 0 (3- 4-) (3- 11-) [1 1] 0 [0 1] 5 -0.5
GraphAddEntries: 1 (23- 8-) (23- 22-) [1 2] 0 0 (12- 4-) (12- 11-) [1 1] 0 [0 1] 5 -0.5
GraphAddEntries: 1 (23- 9-) (23- 23-) [1 2] 0 0 (12- 4-) (12- 11-) [1 1] 0 [0 1] 5 -0.5
GraphAddEntries: 1 (8- 8-) (22- 8-) [2 1] 0 0 (4- 3-) (11- 3-) [1 1] 0 [0 1] 6 -0.5
GraphAddEntries: 1 (9- 8-) (23- 8-) [2 1] 0 0 (4- 3-) (11- 3-) [1 1] 0 [0 1] 6 -0.5
GraphAddEntries: 1 (8- 23-) (22- 23-) [2 1] 0 0 (4- 12-) (11- 12-) [1 1] 0 [0 1] 6 -0.5
GraphAddEntries: 1 (9- 23-) (23- 23-) [2 1] 0 0 (4- 12-) (11- 12-) [1 1] 0 [0 1] 6 -0.5
GraphAddEntries: 0 (3- 4-) (3- 11-) [1 1] 0 1 (8- 8-) (8- 23-) [1 2] 0 [0 1] 5 -0.5
GraphAddEntries: 0 (3- 4-) (3- 11-) [1 1] 0 1 (8- 9-) (8- 23-) [1 2] 0 [0 1] 6 -0.5
GraphAddEntries: 0 (12- 4-) (12- 11-) [1 1] 0 1 (23- 8-) (23- 23-) [1 2] 0 [0 1] 5 -0.5
GraphAddEntries: 0 (12- 4-) (12- 11-) [1 1] 0 1 (23- 9-) (23- 23-) [1 2] 0 [0 1] 6 -0.5
GraphAddEntries: 0 (4- 3-) (11- 3-) [1 1] 0 1 (8- 8-) (23- 8-) [2 1] 0 [0 1] 5 -0.5
GraphAddEntries: 0 (4- 3-) (11- 3-) [1 1] 0 1 (9- 8-) (23- 8-) [2 1] 0 [0 1] 6 -0.5
GraphAddEntries: 0 (4- 12-) (11- 12-) [1 1] 0 1 (8- 23-) (23- 23-) [2 1] 0 [0 1] 5 -0.5
GraphAddEntries: 0 (4- 12-) (11- 12-) [1 1] 0 1 (9- 23-) (23- 23-) [2 1] 0 [0 1] 6 -0.5
""",
}


def drive_sstruct(line: str, device, path=None):
    """The port's sstruct driver on one line (`-in path` prepended when a
    grid-spec file is given), its printout captured and logged.  Returns
    (result, wall seconds)."""
    import contextlib
    import io

    from hypre_tpu_torch.drivers import sstruct as driver

    argv = (["-in", path] if path else []) + line.split()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = driver.run(argv, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for ln in buf.getvalue().splitlines():
        log(f"  sstruct [{torch.device(device).type}] {ln}")
    return res, wall


def sstruct_id(line: str) -> int:
    return int(line.split("-solver")[1].split()[0])


def flat_parts(x) -> torch.Tensor:
    """A solution as one flat f64 tensor: a tensor, a tuple of parts
    (nested), or FAC-AMR's {part: tensor}."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1)
    if isinstance(x, dict):
        return torch.cat([flat_parts(x[k]) for k in sorted(x)])
    return torch.cat([flat_parts(v) for v in x])


def sstruct_true_residual(res, tol: float):
    """(||b - A x|| / ||b|| in f64 of a built-in line, the bound it must
    meet: tol + 4 eps ||A||_inf ||x|| / ||b||), finite x.  SysPFMG (-solver
    3) solves part 0's (0, 0) block alone, so that block is its A."""
    from hypre_tpu_torch.sstruct import sstruct_matvec
    from hypre_tpu_torch.struct import struct_matvec

    A, b = res.A, res.b
    x = flat_parts(res.x)
    require(bool(torch.isfinite(x).all()), "non-finite solution")
    if sstruct_id(res.line) == 3:
        blk = A.diag_block(0, 0)
        r = b[0][0] - struct_matvec(blk, res.x[0])
        bf = b[0][0].reshape(-1)
        norm_inf = float(blk.data.abs().sum(0).max())
    else:
        r = flat_parts(tuple(tuple(bv - av for bv, av in zip(bp, ap))
                             for bp, ap in zip(b, sstruct_matvec(A, res.x))))
        bf = flat_parts(b)
        U = A.u_host.to_scipy()
        norm_inf = max(float(sm.data.abs().sum(0).max())
                       for sm in A.smats.values()) + float(
            abs(U).sum(axis=1).max())
    nb = float(torch.linalg.vector_norm(bf))
    rel = float(torch.linalg.vector_norm(r)) / nb
    bound = tol + 4 * torch.finfo(torch.float64).eps * norm_inf * float(
        torch.linalg.vector_norm(x)) / nb
    return rel, bound


def sstruct_launches(res, its: int) -> dict:
    """The K1 / ELL launches a built-in line's solve makes, from the
    code's own counts: the U product (`kernel_launches(A.umat)`) runs
    once in each sstruct_matvec and once in each Split step; PCG applies
    A and M its + 1 times, a Split solve steps `its` times and takes
    its + 1 residuals; PFMG / SMG cycles, SysPFMG and the diagonal
    scaling launch neither kernel."""
    from hypre_tpu_torch.ops.dia import kernel_launches, sum_launches

    sid = sstruct_id(res.line)
    u = kernel_launches(res.A.umat) if res.A.umat is not None else {}
    if sid == 3:
        k = 0
    elif sid in (0, 1, 8):
        k = 2 * its + 1
    elif sid in (10, 11):
        k = 2 * (its + 1)
    else:
        k = its + 1
    return sum_launches([(u, k)])


def infile_launches(res, its: int) -> dict:
    """The same for an -in line: the frozen monolithic operator `op` its
    + 1 times in PCG, the assembled U once a Split step, BoomerAMG's
    `cycle_launches` once an application, FAC-AMR's coarsest SysPFMG
    transfers (each non-coarsest level's P^T and P) once a cycle."""
    from hypre_tpu_torch.ops.dia import kernel_launches, sum_launches

    sid = sstruct_id(res.line)
    if 50 <= sid < 100:
        cs = res.solver.csolver
        per = [(kernel_launches(M), 1) for M in cs._P + cs._PT if M is not None]
        return sum_launches([(sum_launches(per), its)])
    parts = [(kernel_launches(res.op), its + 1)]
    if sid in (10, 11) and res.A.umat is not None:
        parts.append((kernel_launches(res.A.umat), its + 1))
    if sid == 20:
        parts.append((res.solver.cycle_launches(), its + 1))
    return sum_launches(parts)


def sstruct_iteration(res):
    """One iteration of a Split, PCG + Split or SysPFMG line's solve, for
    the profile: a SysPFMG cycle, a Split step and its residual, PCG's A
    and M."""
    from hypre_tpu_torch.solvers.krylov.common import tzeros_like
    from hypre_tpu_torch.sstruct import sstruct_matvec

    sid, A, b, s = sstruct_id(res.line), res.A, res.b, res.solver
    if sid == 3:
        return lambda: s._cycle_from(res.x, (b[0][0],))
    if sid in (0, 1, 8):
        return lambda: sstruct_matvec(A, s._step(res.x, b))
    return lambda: (sstruct_matvec(A, b), s._step(tzeros_like(b), b))


def drive_checked(label, line, want, dev):
    """A built-in line through the driver with the counts at 0 before and
    read after: its count `want` (None: any), the true residual or the
    max_iter stop, K1 / ELL launches exactly as `sstruct_launches`
    predicts.  Returns (result, wall s, launches, true residual, bound)."""
    zero_counts()
    res, wall = drive_sstruct(line, dev)
    counts = read_counts()
    res.line = line
    its = int(res.num_iterations)
    rel, bound = sstruct_true_residual(res, 1e-6)
    require(want is None or its == want,
            f"sstruct {label} {line}: {its} iterations, pinned {want}")
    sstruct_require_solution(label, res, its, rel, bound)
    expected = {n: 0 for n in counts}
    expected.update(sstruct_launches(res, its))
    require(counts == expected, f"sstruct {label} {line}: launches "
                                f"{counts}, expected {expected}")
    return res, wall, counts, rel, bound


def sstruct_line(label, dev, card) -> dict:
    """One of (a)-(d) at its SSTRUCT96 size (`drive_checked` against the
    count there: the port's CPU count at 96^3, the JAX package's at
    48^3): setup by phase, the solve's median and one
    profiled iteration; then, for SSTRUCT_JAX_CARD, the line at 48^3
    against the JAX package's count (SSTRUCT_JAX)."""
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    line, want = SSTRUCT96[label]
    GLOBAL_TIMER.clear()
    res, wall, counts, rel, bound = drive_checked(label, line, want, dev)
    its = int(res.num_iterations)
    phases = {k: round(GLOBAL_TIMER.seconds(k), 4) for k in STRUCT_PHASES
              if GLOBAL_TIMER.seconds(k)}
    seconds = {"driver": wall, "setup": res.setup_s, "solve": res.solve_s}
    reps = SSTRUCT_REPS[label]
    t = time.perf_counter()
    med, lo, hi = (solve_median_ms(res.resolve, reps) if reps
                   else (res.solve_s * 1e3,) * 3)
    seconds["solves"] = time.perf_counter() - t
    t = time.perf_counter()
    if label in SSTRUCT_PROFILE_SOLVE:
        prof = busy(res.resolve, its, cpu=False)
        prof["wall_ms"] /= its
        prof["busy_ms"] /= its
    else:
        prof = busy(sstruct_iteration(res), 1, cpu=False)
    seconds["profile"] = time.perf_counter() - t
    out = {"line": line, "iterations": its, "cpu_iterations": want,
           "converged": bool(res.converged),
           "rel_residual": float(res.rel_residual_norm),
           "true_rel_residual": rel, "bound": bound, "driver_wall_s": wall,
           "setup_s": res.setup_s, "setup_phases_s": phases,
           "driver_solve_s": res.solve_s, "solve_median_ms": med,
           "solve_reps": reps, "solve_min_max_ms": [lo, hi],
           "iteration_wall_ms": prof["wall_ms"],
           "iteration_busy_ms": prof["busy_ms"],
           "idle_share": prof["idle_share"],
           "kernels_per_iteration": prof["kernels_per_iteration"],
           "launches": dict(counts)}
    del res
    torch.cuda.empty_cache()
    jline, jwant = SSTRUCT_JAX[label]
    jtext = ""
    if label in SSTRUCT_JAX_CARD:
        t = time.perf_counter()
        jres, jwall, jcounts, jrel, _ = drive_checked(label, jline, jwant, dev)
        seconds["48^3 line"] = time.perf_counter() - t
        out["jax_line"] = {"line": jline, "iterations": jwant,
                           "true_rel_residual": jrel, "wall_s": jwall,
                           "launches": jcounts}
        for k, v in jcounts.items():
            out["launches"][k] += v
        jtext = (f"; {jline}: {jres.num_iterations} iterations (JAX {jwant}),"
                 f" true rel residual {jrel:.3e}")
    out["seconds"] = seconds
    if reps:
        solve = (f"median of {reps} {med:.2f} ms ({lo:.2f}-{hi:.2f}; the "
                 f"driver's {out['driver_solve_s'] * 1e3:.2f})")
    else:
        solve = f"the driver's {med:.2f} ms"
    log(f"sstruct {label} [{card}] {line}: {its} iterations (the port's CPU "
        f"count {want}), true rel residual {rel:.3e}; setup "
        f"{out['setup_s']:.2f} s {phases}; solve {solve}; one iteration: "
        f"wall {out['iteration_wall_ms']:.2f} ms, busy "
        f"{out['iteration_busy_ms']:.2f} ms, idle {out['idle_share']:.1%}, "
        f"{out['kernels_per_iteration']:.0f} kernels; launches "
        f"{ {k: v for k, v in counts.items() if v} } (predicted){jtext}; "
        f"seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    return out


def sstruct_require_solution(label, res, its, rel, bound) -> None:
    """A converged line's true residual within its bound; a line that
    stopped at max_iter (as the JAX package's does) reports the residual
    it has (the true one within 1e-3 of the solver's)."""
    if res.converged:
        require(rel < bound, f"sstruct {label}: true residual {rel:.3e} "
                             f"above {bound:.3e}")
        return
    reported = float(res.rel_residual_norm)
    require(its == SSTRUCT_MAX_ITER and abs(rel - reported) <= 1e-3 * reported,
            f"sstruct {label}: unconverged after {its} iterations, true "
            f"residual {rel:.3e}, reported {reported:.3e}")


def sstruct_card_vs_cpu(line: str, card, path=None, tol=1e-12) -> dict:
    """A line on the card and on the CPU: the same count, x within tol of
    max |x|, the card's K1 / ELL launches as predicted."""
    zero_counts()
    rc, wc = drive_sstruct(line, torch.device("cuda", 0), path)
    counts = read_counts()
    rh, wh = drive_sstruct(line, "cpu", path)
    rc.line = rh.line = line
    its = int(rc.num_iterations)
    predict = infile_launches if path else sstruct_launches
    expected = {n: 0 for n in counts}
    expected.update(predict(rc, its))
    xc, xh = flat_parts(rc.x).cpu(), flat_parts(rh.x)
    dx = float((xc - xh).abs().max() / xh.abs().max())
    drel = abs(float(rc.rel_residual_norm) - float(rh.rel_residual_norm))
    log(f"sstruct [{card}] {'-in ' + path.rsplit('/', 1)[1] + ' ' if path else ''}"
        f"{line}: card {its} / CPU {rh.num_iterations} iterations, max rel "
        f"diff of x {dx:.2e}, of the final residual {drel:.2e}; launches "
        f"{ {k: v for k, v in counts.items() if v} }; card {wc:.1f} s, CPU "
        f"{wh:.1f} s")
    require(its == int(rh.num_iterations) and dx <= tol,
            f"sstruct {line}: card and CPU differ")
    require(counts == expected, f"sstruct {line}: launches {counts}, "
                                f"expected {expected}")
    return {"iterations": its, "dx": dx, "converged": bool(rc.converged),
            "rel_residual": float(rc.rel_residual_norm), "card_s": wc,
            "cpu_s": wh, "card_setup_s": rc.setup_s,
            "card_solve_s": rc.solve_s, "launches": counts}


def sstruct_infiles(card) -> dict:
    """(f): every SSTRUCT_INFILES text through `-in`, at its refinement,
    with SSTRUCT_IN_IDS (and FAC-AMR on the FacParts text), card vs CPU."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, text in SSTRUCT_INFILES.items():
            path = f"{tmp}/{name}.in"
            with open(path, "w") as fh:
                fh.write(text)
            ids = SSTRUCT_IN_IDS + ((SSTRUCT_FAC_ID,) if "FacParts" in text
                                    else ())
            for sid in ids:
                line = f"-solver {sid} {SSTRUCT_INFILE_R[name]}".strip()
                out[f"{name} {line}"] = sstruct_card_vs_cpu(line, card, path,
                                                            tol=1e-10)
    return out


def maxwell_cases():
    """(g)'s three SStructMaxwell problems: name -> (constructor kwargs,
    the right-hand side's kind)."""
    from hypre_tpu_torch.models.maxwell import (curlcurl_matrix,
                                                curlcurl_matrix_part)

    gshape = (16, 16, 16)
    parts = [(8, 16, 16), (8, 16, 16)]
    origins = [(0, 0, 0), (8, 0, 0)]
    A_parts = [curlcurl_matrix_part(p, o, gshape, 1.0, 1.0)[0]
               for p, o in zip(parts, origins)]
    rot = [(8, 16, 16), (8, 16, 16)]
    transforms = [((0, 0, 0), (0, 1, 2), (1, 1, 1)),
                  ((16, 16, 0), (0, 1, 2), (-1, -1, 1))]
    s = (MAXWELL_AMS_N,) * 3
    A1 = curlcurl_matrix(*s)[0]
    U = maxwell_interface_u(MAXWELL_AMS_N)
    return {
        "origins TV": (dict(parts=parts, A_parts=A_parts, origins=origins,
                            global_shape=gshape), "parts"),
        "transforms TV": (dict(parts=rot, transforms=transforms), "parts"),
        "block-diagonal + U AMS": (dict(parts=[s, s], A_parts=[A1, A1], U=U),
                                   "A"),
    }


MAXWELL_AMS_N = 24  # (g)'s AMS line: two 24^3 parts, 90,000 edges
MAXWELL_U = -0.1  # the value of each U coupling


def maxwell_interface_u(n: int):
    """(g)'s U over two stacked n^3 parts' edges (edge_structure's
    numbering, part 1 after part 0): each y- and z-edge on part 0's face
    x = n coupled to the edge in the same place on part 1's face x = 0,
    both ways, MAXWELL_U."""
    from hypre_tpu_torch.ops.csr import CSRMatrix

    m = n + 1
    ne = 3 * n * m * m
    rows, cols = [], []
    for d, shape in ((1, (m, n, m)), (2, (m, m, n))):
        ids = np.arange(d * n * m * m, (d + 1) * n * m * m).reshape(shape)
        a, b = ids[n].ravel(), ne + ids[0].ravel()
        rows += [a, b]
        cols += [b, a]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return CSRMatrix.from_coo(rows, cols, np.full(len(rows), MAXWELL_U),
                              (2 * ne, 2 * ne))


def maxwell_launches(mx, its: int) -> dict:
    """PCG's A (its + 1) and preconditioner applications: the TV cycle's
    `cycle_launches`, or AMS's `apply_launches`, its + 2 times (the
    energy-norm test applies M to b once more)."""
    from hypre_tpu_torch.ops.dia import kernel_launches, sum_launches

    if mx.tv is not None:
        A, per = mx.tv.levels[0]["A_f"], mx.tv.cycle_launches()
    else:
        A, per = mx.ams._E, mx.ams.apply_launches()
    return sum_launches([(kernel_launches(A), its + 1), (per, its + 2)])


def sstruct_maxwell(card) -> dict:
    """(g): each SStructMaxwell branch on the card and on the CPU: the
    same count, x within 1e-10 of max |x|, launches as predicted."""
    from hypre_tpu_torch.solvers.sstruct_ls import SStructMaxwell

    out = {}
    dev = torch.device("cuda", 0)
    for name, (kw, rhs) in maxwell_cases().items():
        t0 = time.perf_counter()
        runs = []  # the card's, then the CPU's
        for where in (dev, torch.device("cpu")):
            zero_counts()
            t = time.perf_counter()
            mx = SStructMaxwell(**kw, device=where)
            setup = time.perf_counter() - t
            rng = np.random.default_rng(23)
            t = time.perf_counter()
            if rhs == "parts":
                res = mx.solve_parts([rng.standard_normal(len(m))
                                      for m in mx.edge_maps])
            else:
                b = mx.A.to_scipy() @ rng.standard_normal(mx.A.num_rows)
                res = mx.solve(torch.from_numpy(b).to(where))
            if where.type == "cuda":
                torch.cuda.synchronize()
            runs.append((mx, res, read_counts(), setup,
                         time.perf_counter() - t))
        (mx, rc, counts, setup, solve), (_, rh, _, hsetup, hsolve) = runs
        its = int(rc.num_iterations)
        expected = {n: 0 for n in counts}
        expected.update(maxwell_launches(mx, its))
        dx = float((rc.x.cpu() - rh.x).abs().max() / rh.x.abs().max())
        log(f"sstruct (g) Maxwell {name} [{card}]: {mx.A.num_rows} edges, "
            f"{'TV ' + str(len(mx.tv.levels)) + ' levels' if mx.tv else 'AMS'}"
            f"; card {its} / CPU {rh.num_iterations} iterations, rel residual "
            f"{float(rc.rel_residual_norm):.3e}, max rel diff of x {dx:.2e}; "
            f"setup {setup:.2f} s, solve {solve:.3f} s (CPU {hsetup:.2f} / "
            f"{hsolve:.3f}); launches {({k: v for k, v in counts.items() if v})}"
            f"; {time.perf_counter() - t0:.1f} s")
        require(rc.converged and its == int(rh.num_iterations) and dx <= 1e-10,
                f"sstruct (g) Maxwell {name}: card and CPU differ")
        require(counts == expected, f"sstruct (g) Maxwell {name}: launches "
                                    f"{counts}, expected {expected}")
        out[name] = {"edges": mx.A.num_rows, "iterations": its, "dx": dx,
                     "rel_residual": float(rc.rel_residual_norm),
                     "setup_s": setup, "solve_s": solve, "launches": counts}
    return out


def sstruct_fac(card) -> dict:
    """(h): FAC on `build_composite_amr` as GMRES's preconditioner, the
    shape of tests/test_sstruct.py::test_fac_multilevel_amr (3 levels,
    factors 2 then 4), card vs CPU: the same count, x within 1e-10 (every
    operator of this size is dense: no K1 / ELL launch)."""
    from hypre_tpu_torch.ops.csr import CSRMatrix
    from hypre_tpu_torch.ops.dia import freeze_auto, spmv
    from hypre_tpu_torch.solvers.krylov import GMRESOptions, gmres
    from hypre_tpu_torch.solvers.sstruct_ls.fac import (FAC, FACOptions,
                                                        build_composite_amr)

    A, ranges, _ = build_composite_amr(
        (10, 10), [((2, 2), (5, 5), 2), ((2, 2), (5, 5), 4)])
    n = A.shape[0]
    runs = []  # the card's, then the CPU's
    for where in (torch.device("cuda", 0), torch.device("cpu")):
        zero_counts()
        t = time.perf_counter()
        fac = FAC(A, ranges, FACOptions(max_iter=1), device=where)
        E = freeze_auto(CSRMatrix.from_scipy(A), torch.float64, where)
        b = torch.from_numpy(A @ np.ones(n)).to(where)
        res = gmres(lambda x: spmv(E, x), b,
                    M=lambda r: fac.cycle(r, torch.zeros_like(r)),
                    opts=GMRESOptions(tol=1e-8, max_iter=60, k_dim=30))
        if where.type == "cuda":
            torch.cuda.synchronize()
        runs.append((res, read_counts(), time.perf_counter() - t))
    (rc, counts, wc), (rh, _, wh) = runs
    dx = float((rc.x.cpu() - rh.x).abs().max() / rh.x.abs().max())
    err1 = float((rc.x.cpu() - 1.0).abs().max())
    log(f"sstruct (h) FAC-GMRES [{card}]: {n} composite unknowns, card "
        f"{rc.num_iterations} / CPU {rh.num_iterations} iterations, max rel "
        f"diff of x {dx:.2e}, |x - 1| {err1:.2e}; {wc:.2f} s / CPU {wh:.2f} s")
    require(rc.converged and rc.num_iterations == rh.num_iterations
            and dx <= 1e-10 and err1 <= 1e-5, "sstruct (h): FAC-GMRES differs")
    require(not any(counts.values()), f"sstruct (h): launches {counts}")
    return {"unknowns": n, "iterations": int(rc.num_iterations), "dx": dx,
            "card_s": wc, "cpu_s": wh}


def sstruct_u_case(dev, flush, card) -> dict:
    """(i): the U of (a) alone (-n 96 96 96: 1,769,472 rows, the two
    interface planes' 18,432 couplings on the diagonals -/+ 9,216): K1
    against its plain version, timed (L2 flushed, median of REPS) beside
    the cuSPARSE CSR product of its nonzeros and both bounds: the DIA
    bytes (2 diagonals, x and y) and the nonzero bytes (the nonzeros'
    values, column indices, x at them and y)."""
    from hypre_tpu_torch.drivers.sstruct import build_two_part
    from hypre_tpu_torch.ops.dia import DIAMatrix
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference

    _, A = build_two_part(96, 96, 96, 3, device=dev)
    U = A.umat
    require(isinstance(U, DIAMatrix) and U.offsets == (-9216, 9216),
            f"sstruct (i): U froze as {type(U).__name__}")
    data, offs = U.data, U.offsets
    n = data.shape[1]
    x = torch.from_numpy(np.random.default_rng(29).standard_normal(n)).to(dev)
    zero_counts()
    y = dia_spmv_cuda(data, offs, x)
    y_ref = dia_spmv_reference(data, offs, x)
    torch.cuda.synchronize()
    require(read_counts()["dia_spmv"] == 1, "sstruct (i): K1 did not launch")
    err = float((y - y_ref).abs().max())
    require(err == 0.0, f"sstruct (i): K1 differs from its plain version by {err}")
    Uh = A.u_host.to_scipy().tocsr()
    nnz = Uh.nnz
    with warnings.catch_warnings():  # torch's "sparse CSR is beta" notice
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(Uh.indptr.astype(np.int64)),
            torch.from_numpy(Uh.indices.astype(np.int64)),
            torch.from_numpy(Uh.data), size=Uh.shape).to(dev)
    ms = time_cuda_ms(lambda: dia_spmv_cuda(data, offs, x), flush)
    plain_ms = time_cuda_ms(lambda: dia_spmv_reference(data, offs, x), flush)
    lib_ms = time_cuda_ms(lambda: csr @ x, flush)
    dia_bytes = (len(offs) + 2) * n * 8
    nz_bytes = 2 * nnz * 8 + nnz * 8 + n * 8  # values + cols + x, and y
    bms, by = bound_ms(dia_bytes, 2 * len(offs) * n, torch.float64)
    nz_ms, _ = bound_ms(nz_bytes, 2 * nnz, torch.float64)
    log(f"sstruct (i) U of -n 96 96 96 alone [{card}]: {n} rows, {nnz} "
        f"nonzeros on offsets {offs}; L2 flushed, median of {REPS}: K1 "
        f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, cuSPARSE CSR "
        f"{lib_ms * 1e3:.1f} us; bound {bms * 1e3:.1f} us on "
        f"{dia_bytes / 1e6:.1f} MB of DIA bytes, {nz_ms * 1e3:.1f} us on "
        f"{nz_bytes / 1e6:.1f} MB of nonzero bytes; max abs err {err:.2e}")
    del A, U, csr
    torch.cuda.empty_cache()
    return {"rows": n, "nnz": nnz, "offsets": list(offs), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
            "bound_by": by, "bound_nonzero_bytes_ms": nz_ms,
            "max_abs_err": err}


def phase_sstruct(dev, card, flush):
    """Phase 18: the sstruct interface (module docstring)."""
    t0 = time.perf_counter()
    t = time.perf_counter()
    ucase = sstruct_u_case(dev, flush, card)
    log(f"sstruct (i): {time.perf_counter() - t:.1f} s")
    runs = {}
    for label in SSTRUCT96:
        t = time.perf_counter()
        runs[label] = sstruct_line(label, dev, card)
        runs[label]["wall_s"] = time.perf_counter() - t
        log(f"sstruct {label}: {runs[label]['wall_s']:.1f} s")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    small = {sid: sstruct_card_vs_cpu(f"-n {n} {n} {n} -solver {sid}", card)
             for sid, n in SSTRUCT24.items()}
    log(f"sstruct (e) card vs CPU: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    infiles = sstruct_infiles(card)
    log(f"sstruct (f) -in card vs CPU: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    maxwell = sstruct_maxwell(card)
    log(f"sstruct (g) Maxwell: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    fac = sstruct_fac(card)
    log(f"sstruct (h) FAC: {time.perf_counter() - t:.1f} s")
    total = {name: 0 for name in read_counts()}
    for group in (runs, small, infiles, maxwell):
        for v in group.values():
            for name in total:
                total[name] += v["launches"][name]
    log(f"sstruct launches, lines (a)-(g): {total}")
    log(f"the sstruct phase took {time.perf_counter() - t0:.1f} s")
    return {"lines": runs, "card_vs_cpu_24": small, "infiles": infiles,
            "maxwell": maxwell, "fac": fac, "u_matvec": ucase}, total


# -- 19. the sharded solver ----------------------------------------------
PAR_SHARDS = 4
# the JAX package's dry run on the CPU at 4 shards, f64 (its legs' code,
# `python -m pytest -m slow tests/test_torch_par_amg.py -k jax_count`):
# (a) l1-Jacobi PCG at 48^3 (serial 12 too), (b) hybrid SSOR at 24^3
PAR_JAX = {"a": 12, "b": 6}
PAR_SETUP_NX = 48  # dist_lattice_setup and IJMatrixSharded at 48^3
PAR_CARD_NOTE = (
    "one card: the shards share it, so this run shows partition "
    "invariance (the sharded l1-Jacobi count is the serial one), the halo "
    "plans, the per-shard kernels and the hybrid-GS count at 4 shards; it "
    "cannot show peer-copy (NVLink) times or any speed-up from more cards")


def par_kernels(pamg_a, pamg_b, flush, card) -> dict:
    """Each kernel of the sharded path on one shard's operator, against
    its plain version (1e-12 relative, f64), timed beside it, its bound
    and the cuSPARSE CSR product: K1 on shard 0's extended fine operator
    of (a), the ELL kernel on shard 0's merged level-1 operator of (a),
    gs_sweep on shard 0's forward schedule of (b)'s fine level."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
    from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda, ell_spmv_reference
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda, gs_sweep_reference

    rng = np.random.default_rng(1919)
    out = {}
    D = pamg_a.par_levels[0].A.ext[0]
    dev = D.data.device
    x = torch.from_numpy(rng.standard_normal(D.num_rows)).to(dev)
    E = pamg_a.par_levels[1].A.ell[0]
    xe = torch.from_numpy(rng.standard_normal(E.num_cols)).to(dev)
    cases = (
        ("dia_spmv", f"K1, shard 0 of (a) L0 ({D.num_rows} rows, "
                     f"{len(D.offsets)} offsets)",
         lambda: dia_spmv_cuda(D.data, D.offsets, x),
         lambda: dia_spmv_reference(D.data, D.offsets, x),
         (len(D.offsets) * 8 + 16) * D.num_rows, 2 * len(D.offsets) * D.num_rows,
         operator_csr(D, D.num_rows, D.num_rows, torch.float64), x),
        ("ell_spmv", f"ELL, shard 0 of (a) L1 ({E.num_rows} rows, "
                     f"{E.data.shape[0]} slots, {E.nnz} entries)",
         lambda: ell_spmv_cuda(E.data, E.cols, E.row_len, xe),
         lambda: ell_spmv_reference(E.data, E.cols, xe),
         E.nnz * 12 + E.num_rows * 12 + E.num_cols * 8, 2 * E.nnz,
         csr_from_ell(E, torch.float64), xe))
    for name, label, kern, plain, nbytes, flops, csr, xv in cases:
        y, y_ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        require(rel <= 1e-12, f"par {label}: disagrees with its plain "
                              f"version, rel {rel:.3e}")
        bms, by = bound_ms(nbytes, flops, torch.float64)
        ms = time_cuda_ms(kern, flush)
        plain_ms = time_cuda_ms(plain, flush)
        lib_ms = time_cuda_ms(lambda: csr @ xv, flush)
        out[name] = {"operator": label, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms}
        log(f"par kernel [{label}; {card}]: max abs err {err:.3e} (rel "
            f"{rel:.1e}); {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
            f"cuSPARSE CSR {lib_ms * 1e3:.1f} us, bound {bms * 1e3:.2f} us "
            f"({by})")
    # the shard product itself, on the rows K1's extended operator keeps:
    # data of per rows, x of per + 2h, y of per (the bound a K1 that
    # reads the halo in place, with no extended rows, would have)
    PD = pamg_a.par_levels[0].A
    per, h, k = PD.part.rows_per_shard, PD.h, len(D.offsets)
    kept, kept_by = bound_ms(k * 8 * per + 8 * (per + 2 * h) + 8 * per,
                             2 * k * per, torch.float64)
    out["dia_spmv"].update(kept_rows=per, kept_rows_bound_ms=kept,
                           kept_rows_bound_by=kept_by)
    log(f"par kernel [K1, shard 0 of (a) L0; {card}]: the shard product on "
        f"its {per} kept rows of {D.num_rows} ({1 - per / D.num_rows:.1%} "
        f"of K1's rows discarded) is bound at {kept * 1e3:.2f} us "
        f"({kept_by}), against {out['dia_spmv']['bound_ms'] * 1e3:.2f} us "
        f"for K1's extended operator")
    sched = pamg_b.par_levels[0].gs[(True, False)].scheds[0]
    err, same = hold_gs(sched, "par shard 0 (b) L0 fwd", torch.float64, 1e-12,
                        rng, forms=("plain",), grids=(True,))
    n = sched.n
    u, f = (torch.from_numpy(rng.standard_normal(n)).to(dev) for _ in range(2))
    slabs = sched.slabs(dev)
    m = sched.mat
    nbytes = (m.indptr.numel() * 4 + m.indices.numel() * 12 + n * 8 * 4
              + sched.order.numel() * 8)
    bms, by = bound_ms(nbytes, 2 * m.indices.numel(), torch.float64)
    ms = time_cuda_ms(lambda: gs_sweep_cuda(sched, u, f), flush)
    plain_ms = time_cuda_ms(lambda: gs_sweep_reference(slabs, n, u, f), flush)
    out["gs_sweep"] = {"operator": f"shard 0 of (b) L0, {n} rows, "
                                   f"{sched.num_wavefronts} wavefronts",
                       "max_abs_err": err, "bitwise_wavefront": same,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None}
    log(f"par kernel [gs_sweep, {out['gs_sweep']['operator']}; {card}]: max "
        f"abs err {err:.3e}, the wavefront form's bits; {ms * 1e3:.1f} us, "
        f"plain {plain_ms * 1e3:.1f} us, bound {bms * 1e3:.2f} us ({by})")
    return out


def par_solves(label, amg, pamg, b, card) -> dict:
    """The sharded PCG of a dry-run leg with the counts at 0 before and
    read after: launches exactly (its + 2) cycles (`ParAMG.cycle_launches`)
    and its + 1 sharded fine products; then its median and one profiled
    solve, and the unsharded solve on the same card beside them."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    opts = PCGOptions(tol=1e-8, max_iter=40)
    F = pamg.fine

    def solve():
        return pcg(F.matvec_fn, b, M=pamg.precond, opts=opts)

    zero_counts()
    res = solve()
    got = read_counts()
    its = res.num_iterations
    want = {name: 0 for name in got}
    for name, c in pamg.cycle_launches().items():
        want[name] += c * (its + 2)
    for name, c in F.kernel_launches().items():
        want[name] += c * (its + 1)
    for d in set(pamg.mesh.devices):
        require_no_gs_fault(d, f"par ({label}) sharded solve")
    require(got == want, f"par ({label}): launches {got}, the sharded "
                         f"hierarchy says {want}")
    med, lo, hi = solve_median_ms(solve)
    prof = busy(solve, its, cpu=False)
    E = amg.levels[0].A
    dev0 = pamg.mesh.devices[0]
    bs = torch.cat([blk.to(dev0) for blk in b])[: F.n]

    def serial():
        return pcg(lambda v: spmv(E, v), bs, M=amg.precond, opts=opts)

    s_its = serial().num_iterations
    s_med, s_lo, s_hi = solve_median_ms(serial)
    s_prof = busy(serial, s_its, cpu=False)
    per_it = {k: v / its for k, v in got.items() if v}
    out = {"iterations": its, "serial_iterations": s_its,
           "launches": {k: v for k, v in got.items() if v},
           "launches_per_iteration": per_it,
           "solve_median_ms": med, "solve_min_max_ms": [lo, hi],
           "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
           "kernels_per_iteration": prof["kernels_per_iteration"],
           "serial": {"solve_median_ms": s_med, "solve_min_max_ms": [s_lo, s_hi],
                      "busy_ms": s_prof["busy_ms"],
                      "idle_share": s_prof["idle_share"],
                      "kernels_per_iteration": s_prof["kernels_per_iteration"]}}
    log(f"par ({label}) [{card}]: sharded PCG {its} iterations, median of "
        f"{MEDIAN_REPS} {med:.2f} ms ({lo:.2f}-{hi:.2f}), busy "
        f"{prof['busy_ms']:.2f} ms, idle {prof['idle_share']:.1%}, "
        f"{prof['kernels_per_iteration']:.0f} kernels an iteration, launches "
        f"an iteration { {k: round(v, 2) for k, v in per_it.items()} } "
        f"(predicted, exactly); unsharded on the same card {s_its} "
        f"iterations, {s_med:.2f} ms ({s_lo:.2f}-{s_hi:.2f}), busy "
        f"{s_prof['busy_ms']:.2f} ms, idle {s_prof['idle_share']:.1%}")
    return out


def par_lattice_setup(devices, card) -> dict:
    """dist_lattice_setup at 48^3 on the shards, the table generated a
    shard at a time, against the port's serial device chain on shard 0's
    device: CF, P and the coarse operator bitwise (f64)."""
    from hypre_tpu_torch.ops.device_setup import (device_classical_interp,
                                                  device_rap)
    from hypre_tpu_torch.ops.dia import DIAMatrix
    from hypre_tpu_torch.parallel import make_mesh
    from hypre_tpu_torch.parallel.dist_setup import (dist_lattice_setup,
                                                     local_laplacian_dia_block)
    from hypre_tpu_torch.solvers.amg.device_coarsen import device_pmis

    nx, S = PAR_SETUP_NX, len(devices)
    n = nx**3
    n_loc = n // S
    mesh = make_mesh(S, devices)
    blocks, offsets = zip(*(local_laplacian_dia_block(
        nx, nx, nx, s * n_loc, (s + 1) * n_loc) for s in range(S)))
    offsets = offsets[0]
    blocks = [torch.from_numpy(b).to(d) for b, d in zip(blocks, mesh.devices)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    cf, P, offs_P, A1, offs_1 = dist_lattice_setup(blocks, offsets, n, mesh,
                                                    max_elmts=4)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t
    dev0 = mesh.devices[0]
    data = torch.cat([b.to(dev0) for b in blocks], dim=1)
    t = time.perf_counter()
    scf = device_pmis(data, offsets, n)
    sP, rowmax = device_classical_interp(data, scf, offsets=offsets,
                                         trunc_factor=0.0, max_elmts=4)
    keep = [k for k in range(len(offsets)) if rowmax[k] > 0]
    soffs_P = tuple(offsets[k] for k in keep)
    sP = sP[torch.tensor(keep, device=dev0)]
    sA1, soffs_1 = device_rap(DIAMatrix(sP, soffs_P, n, n),
                              DIAMatrix(data, offsets, n, n))
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t

    def cat(parts):
        return torch.cat([p.to(dev0) for p in parts], dim=-1)

    same = (torch.equal(cat(cf), scf) and offs_P == soffs_P
            and torch.equal(cat(P), sP) and offs_1 == soffs_1
            and torch.equal(cat(A1), sA1))
    require(same, "par: dist_lattice_setup is not the serial device chain "
                  "bit for bit")
    nc = int((scf > 0).sum())
    log(f"par dist_lattice_setup [{nx}^3 on {S} shards; {card}]: CF ({nc} "
        f"C points), P ({len(offs_P)} offsets) and the coarse operator "
        f"({len(offs_1)} offsets) bitwise the serial device chain; "
        f"{dist_s:.2f} s sharded, {serial_s:.2f} s serial")
    return {"rows": n, "coarse_rows": nc, "P_offsets": len(offs_P),
            "A1_offsets": len(offs_1), "sharded_s": dist_s,
            "serial_s": serial_s}


def par_ij(devices, card) -> dict:
    """IJMatrixSharded at 48^3: each shard Sets its block's off-diagonal
    entries and AddTos half of each diagonal, the next shard AddTos the
    other half (rows it does not own); the assembled ParCSR equals
    from_row_blocks of the generated rows (every host array, and a
    product, bitwise)."""
    from hypre_tpu_torch.models import IJMatrixSharded, laplacian_7pt_row_block
    from hypre_tpu_torch.parallel import ParCSR, make_mesh
    from hypre_tpu_torch.parallel.partition import block_partition

    nx, S = PAR_SETUP_NX, len(devices)
    n = nx**3
    mesh = make_mesh(S, devices)
    per = block_partition(n, S).rows_per_shard
    t = time.perf_counter()
    ij = IJMatrixSharded(n, n, mesh=mesh)
    blocks = []
    for s in range(S):
        lo, hi = min(s * per, n), min(s * per + per, n)
        B = laplacian_7pt_row_block(nx, nx, nx, lo, hi).tocoo()
        blocks.append(B.tocsr())
        rows = B.row + lo
        diag = rows == B.col
        ij.set_values(s, rows[~diag], B.col[~diag], B.data[~diag])
        ij.add_to_values(s, rows[diag], B.col[diag], B.data[diag] / 2)
        ij.add_to_values((s + 1) % S, rows[diag], B.col[diag], B.data[diag] / 2)
    A = ij.assemble()
    asm_s = time.perf_counter() - t
    R = ParCSR.from_row_blocks(blocks, (n, n), mesh)
    same = all(np.array_equal(getattr(A, k), getattr(R, k)) for k in (
        "diag_cols", "diag_data", "offd_cols", "offd_data", "diag_counts",
        "offd_counts"))
    x = np.random.default_rng(48).standard_normal(n)
    same = same and np.array_equal(A.unpad(A.matvec(A.pad_vec(x))),
                                   R.unpad(R.matvec(R.pad_vec(x))))
    require(same, "par: IJMatrixSharded is not from_row_blocks' matrix")
    log(f"par IJMatrixSharded [{nx}^3 on {S} shards; {card}]: equal to "
        f"from_row_blocks bit for bit (arrays and a product); assembly "
        f"{asm_s:.2f} s")
    return {"rows": n, "assembly_s": asm_s}


def phase_par(dev, card, flush):
    """Phase 19: the sharded solver (module docstring)."""
    from hypre_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    count = torch.cuda.device_count()
    devices = [f"cuda:{s % count}" for s in range(PAR_SHARDS)]
    log(f"par: {PAR_SHARDS} shards on {devices} ({count} card"
        f"{'s' if count > 1 else ''})")
    log(f"par: {PAR_CARD_NOTE}" if count == 1 else
        f"par: the shards spread over {count} cards")
    seconds = {}
    zero_counts()
    t = time.perf_counter()
    dry = dryrun_multichip(PAR_SHARDS, devices=devices,
                           log=lambda m: log(f"par {m}"))
    dry_total = read_counts()
    seconds["dryrun"] = time.perf_counter() - t
    for d in set(torch.device(x) for x in devices):
        require_no_gs_fault(d, "par dry run")
    require(dry["a"]["iterations"] == dry["a"]["serial_iterations"]
            == PAR_JAX["a"], f"par (a): {dry['a']['iterations']} iterations "
                             f"(serial {dry['a']['serial_iterations']}), the "
                             f"JAX package's {PAR_JAX['a']}")
    require(dry["b"]["iterations"] == PAR_JAX["b"],
            f"par (b): {dry['b']['iterations']} iterations, the JAX "
            f"package's {PAR_JAX['b']}")
    for name in ("dia_spmv", "ell_spmv", "gs_sweep"):
        require(dry_total[name] > 0, f"par: the dry run launched no {name}")
    log(f"par dry run [{card}]: (a) {dry['a']['iterations']} = serial "
        f"{dry['a']['serial_iterations']} = JAX {PAR_JAX['a']}, (b) "
        f"{dry['b']['iterations']} = JAX {PAR_JAX['b']}, (c) rows "
        f"{dry['c']['rows']}; launches (sharded and unsharded solves, "
        f"setups) {dry_total}; {seconds['dryrun']:.1f} s")
    solves = {}
    for leg in ("a", "b"):
        t = time.perf_counter()
        solves[leg] = par_solves(leg, *dry["solvers"][leg], card)
        seconds[f"({leg}) solves"] = time.perf_counter() - t
    # the sharded path's launches: the two sharded solves, each with the
    # counts at 0 just before and read just after (par_solves)
    total = {name: sum(solves[leg]["launches"].get(name, 0)
                       for leg in solves) for name in dry_total}
    for name in ("dia_spmv", "ell_spmv", "gs_sweep"):
        require(total[name] > 0, f"par: the sharded solves launched no "
                                 f"{name}")
    log(f"par sharded solves' launches [{card}]: {total}")
    t = time.perf_counter()
    kern = par_kernels(dry["solvers"]["a"][1], dry["solvers"]["b"][1], flush,
                       card)
    seconds["kernels"] = time.perf_counter() - t
    legs = {k: dry[k] for k in ("a", "b", "c")}
    del dry
    torch.cuda.empty_cache()
    t = time.perf_counter()
    setup = par_lattice_setup(devices, card)
    seconds["dist_lattice_setup"] = time.perf_counter() - t
    t = time.perf_counter()
    ij = par_ij(devices, card)
    seconds["ij"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    log(f"par seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    log(f"the sharded phase took {time.perf_counter() - t0:.1f} s")
    return {"devices": devices, "cards": count, "note": PAR_CARD_NOTE,
            "dryrun": legs, "dryrun_launches": dry_total, "solves": solves,
            "kernels": kern,
            "dist_lattice_setup": setup, "ij": ij, "seconds": seconds}, total


# -- 20. the sharded struct stack and AMG-DD's sharded domains ----------------
PS_SHARDS = 4
# label -> (struct driver line, process grid, cut grid axes, pinned count):
# the 96^3 counts are STRUCT_JAX's (the JAX package's serial driver on the
# CPU; its own tests pin sharded == serial); (c) reuses (a)'s PFMG
PS96 = {
    "(a) PFMG": (STRUCT_JAX["(a)"][0], (PS_SHARDS,), 0, STRUCT_JAX["(a)"][1]),
    "(b) PFMG -c 2 3 40": (STRUCT_JAX["(c)"][0], (2, 2), (0, 1),
                           STRUCT_JAX["(c)"][1]),
    "(c) PFMG-PCG": (STRUCT_JAX["(b)"][0], (PS_SHARDS,), 0,
                     STRUCT_JAX["(b)"][1]),
}
# (d): pfmgbase3d and smgbase3d at 12^3 (STRUCT_REF's [REF] lines), each
# cut along axis 0 (SMG's planes cut) and along axis 2 (SMG's planes whole,
# coarse shards empty)
PS_REF = {"PFMG": STRUCT_REF[2], "SMG": STRUCT_REF[1]}
# (e): SparseMSG 16^3, the JAX driver's count on the CPU (`python -m pytest
# -m slow tests/test_torch_par_struct.py -k chip_pin`, ~1 min), the serial
# port's too
PS_MSG16 = ("-n 16 16 16 -solver 2", 11)
# (f): struct Jacobi and hybrid at 24^3, the card's serial run the pin
PS24 = ("-n 24 24 24 -solver 8", "-n 24 24 24 -solver 25")
# (g): AMG-DD at 24^3 (phase 16 (g)'s: DD_AMG, 8 domains, padding 2) on 4
# shards; its stationary solve is AUX_DD24 (the JAX package's AMGDD.solve);
# PCG with the AMG-DD cycle stalls at 24^3 sharded or not (the cycle is not
# symmetric), so PCG runs on the JAX test's 10^3 problem (tests/
# test_amg.py:477-483), held to the unsharded count
PS_DD_NX, PS_DD_PCG_NX = 24, 10
PS_XTOL = 1e-12  # x against the serial run where not bitwise


def ps_mesh(dims):
    """A mesh of the dims' shards on the card(s), and its axis names."""
    from hypre_tpu_torch.parallel import make_mesh, make_mesh_nd

    count = torch.cuda.device_count()
    devices = [f"cuda:{s % count}" for s in range(int(np.prod(dims)))]
    if len(dims) == 1:
        return make_mesh(devices=devices), "shard"
    mesh = make_mesh_nd(dims, devices=devices)
    return mesh, mesh.axis_names


def ps_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def ps_profile(cycle) -> dict:
    """One cycle under the profiler, the device activity alone."""
    p = busy(cycle, 1, cpu=False)
    return {"cycle_wall_ms": p["wall_ms"], "cycle_busy_ms": p["busy_ms"],
            "idle_share": p["idle_share"],
            "kernels_per_cycle": p["kernels_per_iteration"]}


def ps_struct96(label, dev, card, cache) -> dict:
    """(a)-(c): the serial line's objects (phase 17's, in `cache` under
    phase 17's label, or through the driver, its count the pin), the
    same objects cut to the mesh, the sharded solve with the counts
    at 0 before and read after (the struct path launches none of the
    counted kernels), its count and x against the serial run, each
    solve timed once and warm (an untimed cycle and product first build
    the ghost plans and the block shapes' allocations; the serial solve
    has just run), one cycle of each profiled ((a), (b))."""
    from hypre_tpu_torch.parallel import shard_solver, shard_struct
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
    from hypre_tpu_torch.struct import struct_matvec

    line, dims, gax, want = PS96[label]
    seconds = {}
    t = time.perf_counter()
    if label == "(c) PFMG-PCG":
        A, solver = cache[PS_KEPT["(a) PFMG"]]
    elif PS_KEPT[label] in cache:
        A, solver = cache[PS_KEPT[label]]
    else:
        res, _ = drive_struct(line, dev)
        require(res.converged and res.num_iterations == want,
                f"par_struct {label}: serial {res.num_iterations}, pinned "
                f"{want}")
        A, solver = res.A, res.solver
        cache[PS_KEPT[label]] = (A, solver)
    seconds["serial driver"] = time.perf_counter() - t
    mesh, names = ps_mesh(dims)
    b = torch.ones(A.shape, dtype=torch.float64, device=dev)
    t = time.perf_counter()
    A_sh, (bs,) = shard_struct(A, [np.ones(A.shape)], mesh, names, gax)
    on = shard_solver(solver, A_sh.layout)
    torch.cuda.synchronize()
    seconds["cut"] = time.perf_counter() - t
    if label == "(c) PFMG-PCG":
        opts = PCGOptions(tol=1e-6, max_iter=200, two_norm=True)
        sharded = lambda: pcg(lambda x: struct_matvec(A_sh, x), bs,  # noqa: E731
                              M=on.precond, opts=opts)
        serial = lambda: pcg(lambda x: struct_matvec(A, x), b,  # noqa: E731
                             M=solver.precond, opts=opts)
    else:
        sharded, serial = (lambda: on.solve(bs)), (lambda: solver.solve(b))
    on.cycle(bs)
    struct_matvec(A_sh, bs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    zero_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    rs = sharded()
    end.record()
    end.synchronize()
    counts = read_counts()
    seconds["sharded solve"] = time.perf_counter() - t
    require(not any(counts.values()), f"par_struct {label}: launches "
                                      f"{counts}, the struct path has none")
    rser = serial()
    its = int(rs.num_iterations)
    require(rs.converged and its == rser.num_iterations == want,
            f"par_struct {label}: sharded {its}, serial "
            f"{rser.num_iterations}, pinned {want}")
    x = A_sh.layout.to_host(rs.x)
    xr = rser.x.cpu().numpy()
    dx, bitwise = ps_rel(x, xr), bool(np.array_equal(x, xr))
    require(dx <= PS_XTOL, f"par_struct {label}: x {dx:.2e} from the serial "
                           f"x on the card")
    rel, bound = struct_true_residual(A, torch.from_numpy(x).to(dev), b, 1e-6)
    require(rel < bound, f"par_struct {label}: true residual {rel:.3e}")
    out = {"line": line, "process_grid": list(dims), "iterations": its,
           "pinned": want, "x_rel_to_serial": dx, "x_bitwise": bitwise,
           "true_rel_residual": rel}
    if label == "(c) PFMG-PCG":
        h = rs.res_norms[:its + 1].cpu().numpy()
        hs = rser.res_norms[:its + 1].cpu().numpy()
        out["history_rel_to_serial"] = dh = ps_rel(h, hs)
        require(dh <= 1e-12, f"par_struct {label}: history {dh:.2e} from the "
                             f"serial run's")
    # the counted solve's time (CUDA events, warm), and the serial one's
    out["solve_ms"] = start.elapsed_time(end)
    t = time.perf_counter()
    out["serial_solve_ms"] = solve_median_ms(serial, 1)[0]
    seconds["timed serial solve"] = time.perf_counter() - t
    if label != "(c) PFMG-PCG":
        t = time.perf_counter()
        out["sharded_cycle"] = ps_profile(lambda: on.cycle(bs))
        out["serial_cycle"] = ps_profile(lambda: solver.cycle(b))
        seconds["profiles"] = time.perf_counter() - t
    out["seconds"] = seconds
    prof = (f"; one cycle sharded: busy {out['sharded_cycle']['cycle_busy_ms']:.2f} "
            f"ms of {out['sharded_cycle']['cycle_wall_ms']:.2f}, "
            f"{out['sharded_cycle']['kernels_per_cycle']:.0f} kernels; serial: "
            f"busy {out['serial_cycle']['cycle_busy_ms']:.2f} ms of "
            f"{out['serial_cycle']['cycle_wall_ms']:.2f}, "
            f"{out['serial_cycle']['kernels_per_cycle']:.0f} kernels"
            if "sharded_cycle" in out else
            f"; history within {out['history_rel_to_serial']:.1e} of the "
            f"serial run's")
    log(f"par_struct {label} [{card}] {line} on {dims}: {its} iterations = "
        f"serial = pinned {want}; x {'bitwise' if bitwise else f'{dx:.1e}'} "
        f"the serial x; true rel residual {rel:.3e}; solve {out['solve_ms']:.1f} "
        f"ms (serial {out['serial_solve_ms']:.1f}){prof}; seconds "
        f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return out


def ps_ref_lines(dev, card) -> dict:
    """(d): pfmgbase3d / smgbase3d on 4 shards cut along axis 0 and 2:
    the [REF] counts, SMG's residual within 2e-9 of its pin, x against
    the serial run (bitwise but SMG's whole planes, 1e-12), the coarse
    layouts' empty shards counted."""
    from hypre_tpu_torch.parallel import shard_solver, shard_struct

    out = {}
    mesh, _ = ps_mesh((PS_SHARDS,))
    for name, (line, want, rel_pin) in PS_REF.items():
        res, _ = drive_struct(line, dev)
        xr = res.x.cpu().numpy()
        for gax in (0, 2):
            A_sh, (bs,) = shard_struct(res.A, [np.ones(res.A.shape)], mesh,
                                       grid_axis=gax)
            on = shard_solver(res.solver, A_sh.layout)
            rs = on.solve(bs)
            rel = float(rs.rel_residual_norm)
            x = A_sh.layout.to_host(rs.x)
            dx, bitwise = ps_rel(x, xr), bool(np.array_equal(x, xr))
            empty = sum(lvl.A.layout.block_shape(s)[gax] == 0
                        for lvl in on.levels for s in range(PS_SHARDS))
            key = f"{name} axis {gax}"
            require(rs.converged and rs.num_iterations == want,
                    f"par_struct (d) {key}: {rs.num_iterations}, [REF] {want}")
            require(rel_pin is None or abs(rel - rel_pin) < 2e-9,
                    f"par_struct (d) {key}: residual {rel:.6e}, [REF] {rel_pin}")
            require(dx <= PS_XTOL, f"par_struct (d) {key}: x {dx:.2e} from "
                                   f"the serial x")
            require(gax == 0 or empty > 0, f"par_struct (d) {key}: no coarse "
                                           f"shard empty")
            out[key] = {"iterations": int(rs.num_iterations), "rel": rel,
                        "x_bitwise": bitwise, "x_rel_to_serial": dx,
                        "empty_coarse_blocks": int(empty)}
    log(f"par_struct (d) [{card}] the [REF] lines on 4 shards: {out}")
    return out


def ps_sparse_msg(dev, card) -> tuple:
    """(e): SparseMSG 16^3, serial on the card and on 4 shards: the
    pinned count, every transfer a ParCSR (one ELL launch a shard),
    launches exactly `cycle_launches` x the cycles, x within 1e-12; the
    counted solve timed warm, after an untimed cycle."""
    from hypre_tpu_torch.parallel import shard_solver, shard_struct

    line, want = PS_MSG16
    res, wall = drive_struct(line, dev)
    require(res.converged and res.num_iterations == want,
            f"par_struct (e): serial {res.num_iterations}, pinned {want}")
    mesh, _ = ps_mesh((PS_SHARDS,))
    t = time.perf_counter()
    A_sh, (bs,) = shard_struct(res.A, [np.ones(res.A.shape)], mesh)
    on = shard_solver(res.solver, A_sh.layout)
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t
    on.cycle(bs)
    torch.cuda.synchronize()
    t = time.perf_counter()
    zero_counts()
    rs = on.solve(bs)
    torch.cuda.synchronize()
    counts = read_counts()
    solve_s = time.perf_counter() - t
    its = int(rs.num_iterations)
    per = on.cycle_launches()
    want_counts = expect([(per, its)])
    transfers = len(on.Rdev) + len(on.Pdev)
    require(rs.converged and its == want, f"par_struct (e): sharded {its}, "
                                          f"pinned {want}")
    require(counts == want_counts and per == {"ell_spmv": PS_SHARDS * transfers},
            f"par_struct (e): launches {counts}, predicted {want_counts}")
    x = A_sh.layout.to_host(rs.x)
    dx = ps_rel(x, res.x.cpu().numpy())
    require(dx <= PS_XTOL, f"par_struct (e): x {dx:.2e} from the serial x")
    b = torch.ones(res.A.shape, dtype=torch.float64, device=dev)
    prof = ps_profile(lambda: on.cycle(bs))
    sprof = ps_profile(lambda: res.solver.cycle(b))
    out = {"line": line, "iterations": its, "pinned": want,
           "transfers": transfers, "ell_per_shard_per_cycle": transfers,
           "launches": counts, "x_rel_to_serial": dx, "cut_s": cut_s,
           "solve_s": solve_s, "serial_driver_s": wall,
           "sharded_cycle": prof, "serial_cycle": sprof}
    log(f"par_struct (e) [{card}] {line} on 4 shards: {its} iterations = "
        f"pinned {want}; {transfers} transfers, ELL {transfers} a shard a "
        f"cycle, launches {counts['ell_spmv']} = {PS_SHARDS} x {transfers} x "
        f"{its} (exactly); x {dx:.1e} from the serial x; cut {cut_s:.1f} s, "
        f"sharded solve {solve_s:.2f} s (serial driver {wall:.2f} s); one "
        f"cycle sharded busy {prof['cycle_busy_ms']:.2f} ms of "
        f"{prof['cycle_wall_ms']:.2f}, {prof['kernels_per_cycle']:.0f} kernels; "
        f"serial busy {sprof['cycle_busy_ms']:.2f} ms of "
        f"{sprof['cycle_wall_ms']:.2f}, {sprof['kernels_per_cycle']:.0f} kernels")
    return out, counts


def ps_jacobi_hybrid(dev, card) -> dict:
    """(f): struct Jacobi and hybrid at 24^3 on 4 shards against the
    serial run on the card: the same count, x within 1e-12."""
    from hypre_tpu_torch.parallel import shard_solver, shard_struct

    out = {}
    mesh, _ = ps_mesh((PS_SHARDS,))
    for line in PS24:
        res, wall = drive_struct(line, dev)
        A_sh, (bs,) = shard_struct(res.A, [np.ones(res.A.shape)], mesh)
        t = time.perf_counter()
        rs = shard_solver(res.solver, A_sh.layout).solve(bs)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t
        x = A_sh.layout.to_host(rs.x)
        xr = res.x.cpu().numpy()
        dx = ps_rel(x, xr)
        require(rs.num_iterations == res.num_iterations and dx <= PS_XTOL,
                f"par_struct (f) {line}: sharded {rs.num_iterations} / serial "
                f"{res.num_iterations}, x {dx:.2e}")
        out[line] = {"iterations": int(rs.num_iterations), "x_rel_to_serial": dx,
                     "x_bitwise": bool(np.array_equal(x, xr)),
                     "solve_s": solve_s, "serial_driver_s": wall}
    log(f"par_struct (f) [{card}] Jacobi / hybrid 24^3 on 4 shards vs the "
        f"serial card run: {out}")
    return out


def ps_amgdd(dev, card) -> tuple:
    """(g): AMGDDDevice at 24^3, 8 domains on 4 shards, f64 and f32: one
    sharded cycle against the unsharded one on the card (f64 1e-12, f32
    phase 16 (g)'s 1e-5), K2 launches a shard as `shard_launches` predicts; the
    stationary solve with the sharded f64 cycle at AUX_DD24 and the
    unsharded count; PCG with it at 10^3 at the unsharded count."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops.dia import kernel_launches, spmv
    from hypre_tpu_torch.solvers.amg import (AMGDD, AMGDDDevice, AMGDDOptions,
                                             BoomerAMG, BoomerAMGOptions)
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    mesh, _ = ps_mesh((PS_SHARDS,))
    total = {name: 0 for name in read_counts()}

    def counted(fn):
        zero_counts()
        r = fn()
        torch.cuda.synchronize()
        c = read_counts()
        for k in total:
            total[k] += c[k]
        return r, c

    def build(nx):
        amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**DD_AMG),
                        device=dev)
        return amg, AMGDD(amg, AMGDDOptions(num_domains=8, padding=2))

    t = time.perf_counter()
    amg, dd = build(PS_DD_NX)
    setup_s = time.perf_counter() - t
    n = amg.levels[0].A.num_rows
    rt = torch.from_numpy(np.random.default_rng(2020).standard_normal(n)).to(dev)
    out = {"setup_s": setup_s}
    for dtype, tol in ((np.float64, 1e-12), (np.float32, 1e-5)):
        one = AMGDDDevice(dd, dtype=dtype, device=dev)
        sh = AMGDDDevice(dd, dtype=dtype, mesh=mesh)
        z1 = one.cycle(rt)
        zs, c = counted(lambda: sh.cycle(rt))
        want = expect([(sh.cycle_launches(), 1)])
        rel = ps_rel(zs.cpu().numpy(), z1.cpu().numpy())
        key = np.dtype(dtype).name
        require(rel <= tol, f"par_struct (g) {key}: the sharded cycle is "
                            f"{rel:.2e} from the unsharded one")
        require(c == want, f"par_struct (g) {key}: launches {c}, predicted "
                           f"{want} ({sh.shard_launches()} a shard)")
        out[key] = {"cycle_rel_to_unsharded": rel,
                    "bitwise": bool(torch.equal(zs, z1)), "launches": c,
                    "per_shard": sh.shard_launches(),
                    "cycle_ms": solve_median_ms(lambda: sh.cycle(rt))[0],
                    "unsharded_cycle_ms": solve_median_ms(lambda: one.cycle(rt))[0]}
        if dtype == np.float64:
            E = amg.levels[0].A
            b = torch.ones(n, dtype=torch.float64, device=dev)

            def stationary(dv):
                x, its = torch.zeros_like(b), 0
                bn = float(torch.linalg.vector_norm(b))
                while its < 100:
                    r = b - spmv(E, x)
                    if float(torch.linalg.vector_norm(r)) / bn < 1e-8:
                        break
                    x, its = x + dv.cycle(r), its + 1
                return its

            its, c = counted(lambda: stationary(sh))
            its1 = stationary(one)
            want = expect([(sh.cycle_launches(), its),
                           (kernel_launches(E), its + 1)])
            require(its == its1 == AUX_DD24 and c == want,
                    f"par_struct (g): stationary solve {its} (unsharded {its1}, "
                    f"pinned {AUX_DD24}), launches {c}, predicted {want}")
            out["stationary"] = {"iterations": its, "launches": c}
            amg10, dd10 = build(PS_DD_PCG_NX)
            E10 = amg10.levels[0].A
            b10 = torch.ones(E10.num_rows, dtype=torch.float64, device=dev)
            opts = PCGOptions(tol=1e-8, max_iter=100)
            sh10 = AMGDDDevice(dd10, dtype=np.float64, mesh=mesh)
            res, c = counted(lambda: pcg(lambda v: spmv(E10, v), b10,
                                         M=sh10.precond, opts=opts))
            ref = pcg(lambda v: spmv(E10, v), b10, M=AMGDDDevice(
                dd10, dtype=np.float64, device=dev).precond, opts=opts)
            k = res.num_iterations
            # PCG applies M to b, to r0 and once an iteration, A to x0
            # and once an iteration (the two-norm test off)
            want = expect([(sh10.cycle_launches(), k + 2),
                           (kernel_launches(E10), k + 1)])
            require(res.converged and k == ref.num_iterations and c == want,
                    f"par_struct (g): PCG at 10^3 {k} (unsharded "
                    f"{ref.num_iterations}), launches {c}, predicted {want}")
            out["pcg_10"] = {"iterations": k, "launches": c}
    log(f"par_struct (g) [{card}] AMG-DD {PS_DD_NX}^3, 8 domains on 4 shards: "
        f"{out}")
    return out, total


def phase_par_struct(dev, card, kept=None):
    """Phase 20: the sharded struct stack and AMG-DD's sharded domains
    (module docstring); `kept`: phase 17's (A, solver) of its (a) and (c)
    lines (PS_KEPT), else they are built here.  Returns (numbers, the
    launches of the phase's counted runs)."""
    t0 = time.perf_counter()
    log(f"par_struct: {PS_SHARDS} shards on the card(s): {PAR_CARD_NOTE}")
    seconds, runs, cache = {}, {}, dict(kept or {})
    for label in PS96:
        t = time.perf_counter()
        runs[label] = ps_struct96(label, dev, card, cache)
        seconds[label] = time.perf_counter() - t
    del cache
    torch.cuda.empty_cache()
    t = time.perf_counter()
    runs["(d) [REF]"] = ps_ref_lines(dev, card)
    seconds["(d)"] = time.perf_counter() - t
    t = time.perf_counter()
    runs["(e) SparseMSG"], msg_counts = ps_sparse_msg(dev, card)
    seconds["(e)"] = time.perf_counter() - t
    t = time.perf_counter()
    runs["(f) Jacobi / hybrid"] = ps_jacobi_hybrid(dev, card)
    seconds["(f)"] = time.perf_counter() - t
    t = time.perf_counter()
    runs["(g) AMG-DD"], dd_counts = ps_amgdd(dev, card)
    seconds["(g)"] = time.perf_counter() - t
    total = {k: msg_counts[k] + dd_counts[k] for k in msg_counts}
    for name in ("ell_spmv", "take_along_axis", "flat_take"):
        require(total[name] > 0, f"par_struct: the phase launched no {name}")
    runs["seconds"] = seconds
    log(f"par_struct seconds { {k: round(v, 1) for k, v in seconds.items()} }")
    log(f"par_struct launches: {total}")
    log(f"the sharded struct phase took {time.perf_counter() - t0:.1f} s")
    return runs, total


def counted_wrappers():
    """{kernel name: its wrapper}; each wrapper's `launches` counts its
    kernel's launches."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda
    from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda
    from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda, take_along_axis_cuda
    from hypre_tpu_torch.ops.tail_kernel import coo_tail_cuda
    from hypre_tpu_torch.ops.cell_dense_kernel import cell_dense_cuda
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda

    return {"dia_spmv": dia_spmv_cuda, "ell_spmv": ell_spmv_cuda,
            "take_along_axis": take_along_axis_cuda, "flat_take": flat_take_cuda,
            "coo_tail": coo_tail_cuda, "cell_dense": cell_dense_cuda,
            "gs_sweep": gs_sweep_cuda}


def zero_counts() -> None:
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda

    for fn in counted_wrappers().values():
        fn.launches = 0
    dia_spmv_cuda.tail_launches = 0
    gs_sweep_cuda.syncfree_launches = 0


def read_counts() -> dict:
    """Each kernel's launches, and "dia_spmv_tail": K1's launches that
    carried a tail (counted by K1's wrapper beside its launches)."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda

    counts = {name: fn.launches for name, fn in counted_wrappers().items()}
    counts["dia_spmv_tail"] = dia_spmv_cuda.tail_launches
    return counts


def ptxas_summary(out: str) -> str:
    """One line from a build's compiler output: the kernels ptxas
    reported, their register range and spill bytes, and any line that
    is neither (a warning, say)."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", out)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", out))
    other = [ln.strip() for ln in out.splitlines() if ln.strip() and not
             re.search(r"ptxas info|bytes stack frame|Compile time", ln)]
    if not regs:
        return "no ptxas report" + (f"; {' | '.join(other)}" if other else "")
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes spilled" + (f"; {' | '.join(other)}" if other else ""))


def build_all():
    """Build every library from the sources, nvcc and cc at once.
    Returns [(name, seconds, compiler log)]."""
    from hypre_tpu_torch import native
    from hypre_tpu_torch.ops import (cell_dense_kernel, dia_kernel, ell_kernel,
                                     gather_kernel, gs_kernel, tail_kernel)

    def timed_build(name, fn):
        t0 = time.perf_counter()
        r = fn()
        return name, time.perf_counter() - t0, r[1] if isinstance(r, tuple) else ""

    jobs = (("dia_spmv.cu", dia_kernel.load), ("ell_spmv.cu", ell_kernel.load),
            ("gather.cu", gather_kernel.load), ("coo_tail.cu", tail_kernel.load),
            ("cell_dense.cu", cell_dense_kernel.load),
            ("gs_sweep.cu", gs_kernel.load), ("host_kernels.c", native.load))
    with ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(lambda j: timed_build(*j), jobs))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    card = smi

    # -- 2. builds ---------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = {}
    for name, secs, out in build_all():
        build_logs[name] = out
        log(f"build: {name} {secs:.2f} s; {ptxas_summary(out)}")
    log(f"build: all libraries in {time.perf_counter() - t0:.2f} s")

    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    # what the timing method reads for a kernel that does no work
    log(f"timing floor ({card}): an empty kernel reads "
        f"{time_cuda_ms(lambda: torch.cuda._sleep(0), flush) * 1e3:.1f} us")
    # phase 17's (j) here, before any profile (struct_matvec_case)
    t0 = time.perf_counter()
    struct_matvec = struct_matvec_case(dev, flush, card)
    log(f"struct (j): {time.perf_counter() - t0:.1f} s")
    # -- 3. K1 against its plain version ------------------------------------
    k1 = phase_k1(dev, flush, card)
    k1_forms = phase_k1_forms(dev, flush, card)
    # -- 4. the gathers (K2, K3) --------------------------------------------
    t_gathers = time.perf_counter()
    gather_launches, gather_times = phase_gathers(dev, flush, card,
                                                  build_logs["gather.cu"])
    log(f"the gather phase took {time.perf_counter() - t_gathers:.1f} s")

    # -- 5. small-input agreement of the whole slice: card vs CPU -----------
    o64 = slice_options(dtype="float64")
    amg_g, res_g, _, _ = run_slice(24, o64, dev)
    amg_c, res_c, _, _ = run_slice(24, o64, "cpu")
    dx = float((res_g.x.cpu() - res_c.x).abs().max() / res_c.x.abs().max())
    log(f"24^3 f64 card vs CPU: iterations {res_g.num_iterations} vs "
        f"{res_c.num_iterations}, max rel diff of x {dx:.3e}")
    require(res_g.num_iterations == res_c.num_iterations == 16 and dx < 1e-9,
            "24^3 slice differs between the card and the CPU")
    # the same through the lattice forms (the relocation engages at this
    # size only with relocate_min_n2=0), with the level-1 values from the
    # host branch (device_rap=False); the 96^3 lattice runs take the
    # device RAP
    l24 = lattice_options(24, dtype="float64", relocate_min_n2=0,
                          device_rap=False)
    amg_g, res_g, _, _ = run_slice(24, l24, dev)
    amg_c, res_c, _, _ = run_slice(24, l24, "cpu")
    dx = float((res_g.x.cpu() - res_c.x).abs().max() / res_c.x.abs().max())
    forms = [describe(l.A)[0] for l in amg_g.levels]
    log(f"24^3 f64 lattice path {forms}, card vs CPU: iterations "
        f"{res_g.num_iterations} vs {res_c.num_iterations}, max rel diff of "
        f"x {dx:.3e}")
    require(res_g.num_iterations == res_c.num_iterations == 16 and dx < 1e-9,
            "24^3 lattice path differs between the card and the CPU")
    require(forms == [describe(l.A)[0] for l in amg_c.levels]
            and any(f.startswith(("scatter", "on_cells")) for f in forms),
            f"24^3 lattice hierarchy {forms}: the relocation did not engage")
    del amg_g, amg_c
    # -- (a) entry()'s configuration: card vs CPU ---------------------------
    entry_run = phase_entry(card)

    # -- 6. the slice in f64 at 96^3 ----------------------------------------
    n = NX**3
    GLOBAL_TIMER.clear()
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(NX, o64, dev)
    path64 = read_counts()
    launches, ell_launches = path64["dia_spmv"], path64["ell_spmv"]
    log(f"launches in the f64 96^3 run: {path64}")
    log("setup phases, f64 96^3 (host clock; FREEZE synchronizes the card):")
    for line in GLOBAL_TIMER.summary().splitlines():
        log(f"  {line}")
    rel, bound = check_solution(amg, res, n)
    fmts = ", ".join(f"L{k} {type(l.A).__name__[:-6]} {l.A.num_rows}"
                     for k, l in enumerate(amg.levels))
    per_cycle64 = sum(k for _, _, k in ell_operators(amg))
    ell_expected = per_cycle64 * (res.num_iterations + 1)
    log(f"slice f64 96^3 ({card}): levels [{fmts}]; setup {setup_s:.2f} s, "
        f"solve {solve_s:.4f} s ({n / solve_s:.4g} DOF/s), "
        f"{res.num_iterations} iterations, final rel residual "
        f"{float(res.rel_residual_norm):.3e} (true, in f64: {rel:.3e}, bound "
        f"{bound:.1e}), K1 launches {launches}, ELL launches {ell_launches} "
        f"(expected {per_cycle64}/cycle x {res.num_iterations + 1} cycles = "
        f"{ell_expected})")
    require(res.converged and res.num_iterations == ORACLE_F64,
            f"f64 slice: {res.num_iterations} iterations, oracle {ORACLE_F64}")
    require(launches > 0, "the f64 slice did not launch K1")
    require(ell_launches == ell_expected > 0,
            "the f64 slice's ELL matvecs did not all launch the ELL kernel")
    require(path64 == expected_launches(amg, res.num_iterations),
            f"the f64 slice's launches {path64} are not its operators' "
            f"{expected_launches(amg, res.num_iterations)}")
    ell64, ell_err, ell_forms64 = phase_ell(amg, 1e-12, flush, card, "f64")
    del amg, res

    # -- 8a. the lattice path in f64 at 96^3 ---------------------------------
    amg, res, lat64, _, _ = run_lattice(
        NX, lattice_options(NX, dtype="float64"), dev, card, "f64",
        {ORACLE_F64}, launches)
    fused64, fused_err = phase_fused_tails(amg, 1e-12, flush, card, "f64")
    cell64 = phase_cell_dense(amg, 1e-12, flush, card, "f64")
    tail64, tail_err, tail_entries = phase_tail(amg, 1e-12, flush, card, "f64")
    take64, take_shapes = phase_path_gathers(amg, flush, card, "f64")
    lat_rows64 = phase_lattice_ops(amg, 1e-12, flush, card, "f64")
    rap64 = phase_device_rap(amg, card, "f64")
    del amg, res
    torch.cuda.empty_cache()

    # -- 7. f32 vectors, bf16 matrices, nongalerkin 0.02 ---------------------
    o32 = slice_options(dtype="float32", mat_dtype="bfloat16",
                        nongalerkin_tol=0.02)
    zero_counts()
    amg, res, setup_s, solve_s = run_slice(NX, o32, dev)
    path32 = read_counts()
    launches32, ell_launches32 = path32["dia_spmv"], path32["ell_spmv"]
    log(f"launches in the f32/bf16 96^3 run: {path32}")
    rel, bound = check_solution(amg, res, n)
    per_cycle = sum(k for _, _, k in ell_operators(amg))
    log(f"slice f32/bf16/ngt0.02 96^3 ({card}): setup {setup_s:.2f} s, solve "
        f"{solve_s:.4f} s ({n / solve_s:.4g} DOF/s), {res.num_iterations} "
        f"iterations (JAX package: {PRODUCTION_F32}), final rel residual "
        f"{float(res.rel_residual_norm):.3e} (true, in f64: {rel:.3e}, bound "
        f"{bound:.1e}), K1 launches {launches32}, ELL launches "
        f"{ell_launches32} (expected {per_cycle}/cycle x "
        f"{res.num_iterations + 1} cycles = "
        f"{per_cycle * (res.num_iterations + 1)})")
    require(res.converged and abs(res.num_iterations - PRODUCTION_F32) <= 1,
            f"f32/bf16 slice: {res.num_iterations} iterations, "
            f"expected {PRODUCTION_F32} +- 1")
    require(launches32 > 0, "the f32/bf16 slice did not launch K1")
    require(ell_launches32 == per_cycle * (res.num_iterations + 1) > 0,
            "the f32/bf16 slice's ELL matvecs did not all launch the ELL kernel")
    require(path32 == expected_launches(amg, res.num_iterations),
            f"the f32/bf16 slice's launches {path32} are not its operators' "
            f"{expected_launches(amg, res.num_iterations)}")
    phase_ell(amg, 1e-5, flush, card, "bf16/f32")
    del amg, res

    # -- 8b. the lattice path in f32 / bf16 / ngt 0.02 at 96^3 ---------------
    amg, res, lat32, _, _ = run_lattice(
        NX, lattice_options(NX, dtype="float32", mat_dtype="bfloat16",
                            nongalerkin_tol=0.02), dev, card, "f32/bf16",
        {PRODUCTION_F32 - 1, PRODUCTION_F32, PRODUCTION_F32 + 1}, launches32)
    fused32, _ = phase_fused_tails(amg, 1e-5, flush, card, "bf16/f32")
    cell32 = phase_cell_dense(amg, 1e-4, flush, card, "f32")
    phase_tail(amg, 1e-5, flush, card, "bf16/f32")
    phase_path_gathers(amg, flush, card, "bf16/f32")
    lat_rows32 = phase_lattice_ops(amg, 1e-5, flush, card, "bf16/f32")
    rap32 = phase_device_rap(amg, card, "f32/bf16")
    del amg, res
    torch.cuda.empty_cache()

    # -- 11. bench.py's device setup chain at 96^3 ------------------------
    ds_t0 = time.perf_counter()
    ds = phase_device_setup(dev, card)
    log(f"the device setup phase took {time.perf_counter() - ds_t0:.1f} s")

    # -- 10. the GS family: relax 13 / 14 at 96^3, the kernel held ---------
    gs_t0 = time.perf_counter()
    t_step = phase_gs_step(dev, card)
    amg, gs64 = run_gs(NX, slice_options(dtype="float64", relax_down=13,
                                         relax_up=14), dev, card, "f64",
                       GS96_F64)
    gs_tot, gs_err, gs_same, gs_rows, gs_lib_why = phase_gs_sweeps(
        amg, flush, card, "f64", t_step["ns"])
    del amg
    torch.cuda.empty_cache()
    amg, gs32 = run_gs(NX, slice_options(
        dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02,
        relax_down=13, relax_up=14), dev, card, "f32/bf16", GS96_F32)
    rng = np.random.default_rng(19)
    held32 = [hold_gs(S, f"f32/bf16 {name}", torch.float32, 1e-6, rng,
                      forms=("plain",), grids=(True,))
              for name, S in gs_schedules(amg)]
    gs32_err = max(e for e, _ in held32)
    gs_same += sum(k for _, k in held32)
    log(f"gs_sweep [f32/bf16 96^3; {card}]: every schedule's sync-free sweep "
        f"agrees with the plain version, max abs err {gs32_err:.2e}, and is "
        f"the wavefront form's bits")
    del amg, flush
    torch.cuda.empty_cache()
    gs_masked = phase_gs_masked(dev, card)
    from hypre_tpu_torch.solvers.amg import BoomerAMGOptions
    gs_defaults = card_vs_cpu(24, BoomerAMGOptions(), dev,
                              "BoomerAMGOptions()", DEFAULT24_F64)
    gs_cheby = card_vs_cpu(48, slice_options(dtype="float64", relax_down=16,
                                             relax_up=16), dev,
                           "Chebyshev (relax 16) f64", CHEBY48_F64)
    log(f"the GS family's phases took {time.perf_counter() - gs_t0:.1f} s")
    gs_runs = {"gs f64": gs64, "gs f32/bf16": gs32,
               "BoomerAMGOptions() 24^3": gs_defaults,
               "cheby 48^3": gs_cheby}

    # -- (c) extended+i interpolation ---------------------------------------
    ext = phase_ext(dev, card)

    # -- 12. the cycle options and the coarsening family -------------------
    cyc_t0 = time.perf_counter()
    cycles, cycles24 = phase_cycles(dev, card)
    log(f"the cycle phase took {time.perf_counter() - cyc_t0:.1f} s")

    # -- 13. aggressive coarsening, the interpolation family, AIR ----------
    agg_t0 = time.perf_counter()
    agg, agg24, air24 = phase_agg(dev, card)
    log(f"the aggressive coarsening / interpolation / AIR phase took "
        f"{time.perf_counter() - agg_t0:.1f} s")

    # -- 14. systems / nodal / GSMG, the Krylov family, LOBPCG ------------
    sys_t0 = time.perf_counter()
    systems, systems24, k1_sys = phase_systems(dev, card)
    log(f"the systems / Krylov / LOBPCG phase took "
        f"{time.perf_counter() - sys_t0:.1f} s")

    # -- 15. the ij driver, IJ assembly, checkpoints, hybrid, ILU ----------
    ij_runs, ij_asm, ij_small = phase_ij(dev, card)

    # -- 16. the AMG family ------------------------------------------------
    family, family_small, family_total, dd_gathers = phase_family(dev, card)

    # -- 17. the struct interface -------------------------------------------
    struct, struct_total, struct_kept = phase_struct(dev, card, struct_matvec)

    # -- 18. the sstruct interface ------------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    sstruct, sstruct_total = phase_sstruct(dev, card, flush)

    # -- 19. the sharded solver ---------------------------------------------
    par, par_total = phase_par(dev, card, flush)
    del flush

    # -- 20. the sharded struct stack, AMG-DD's sharded domains ------------
    par_struct, par_struct_total = phase_par_struct(dev, card, struct_kept)
    del struct_kept

    # `launches` counts the two f64 96^3 runs, the plain path's and the
    # lattice path's, phase 16's lines (a)-(h), phase 17's (a)-(e),
    # phase 18's (a)-(g), phase 19's two sharded solves and phase 20's
    # counted runs, each driven with the counts at 0 just before and read
    # just after;
    # "per" says what the times cover
    def entry(name, source, replaces, err, ms, plain_ms, lib_ms, bms, by,
              **per):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": (path64[name] + lat64[name] + family_total[name]
                             + struct_total[name] + sstruct_total[name]
                             + par_total[name] + par_struct_total[name]),
                "path_launches": {"plain f64": path64[name],
                                  "lattice f64": lat64[name],
                                  "plain f32/bf16": path32[name],
                                  "lattice f32/bf16": lat32[name],
                                  "entry": entry_run["launches"][name],
                                  **{f"ext+i {k}": v["launches"][name]
                                     for k, v in ext.items()},
                                  **{f"device setup {k}": v["launches"][name]
                                     for k, v in ds.items()},
                                  **{k: v["launches"][name]
                                     for k, v in gs_runs.items()},
                                  **{f"cycles {k}": v["launches"][name]
                                     for k, v in cycles.items()},
                                  **{f"agg {k}": v["launches"][name]
                                     for k, v in agg.items()},
                                  **{f"systems {k}": v["launches"][name]
                                     for k, v in systems.items()},
                                  **{f"ij {k}": v["launches"][name]
                                     for k, v in ij_runs.items()},
                                  "family": family_total[name],
                                  "struct": struct_total[name],
                                  "sstruct": sstruct_total[name],
                                  "par": par_total[name],
                                  "par_struct": par_struct_total[name]},
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, **per}

    def lattice_rows(rows):
        keys = ("operator", "format", "offsets", "tail_entries", "bytes",
                "per_cycle", "ms", "library_ms", "bound_ms")
        return [{k: r[k] for k in keys} for r in rows]

    def fused_cycle(tot):
        """The tailed operators of one lattice V-cycle in its forms."""
        return dict(zip(("ms", "unfused_ms", "bound_ms"), tot),
                    bound_by="bytes", per="v_cycle")

    def form_times(forms, per):
        """{form: {ms, unfused_ms, bound_ms, bound_by, max_abs_err, per}}"""
        keys = ("ms", "unfused_ms", "bound_ms", "bound_by", "max_abs_err")
        return {f: {**dict(zip(keys, v)), "per": per if f != "v_cycle"
                    else "v_cycle"} for f, v in forms.items()}

    ms, plain_ms, lib_ms, err, bms, by = k1["96^3 f64"]
    kernels = [
        entry("dia_spmv", "hypre_tpu_torch/csrc/dia_spmv.cu",
              "hypre_tpu/ops/pallas_dia.py:104", err, ms, plain_ms, lib_ms,
              bms, by, per="launch",
              forms=form_times(k1_forms["96^3 f64"], "launch"),
              # K1 launches that carried a tail, and the tailed operators
              # of a lattice V-cycle against K1 + coo_tail + epilogue
              tail_launches={"lattice f64": lat64["dia_spmv_tail"],
                             "lattice f32/bf16": lat32["dia_spmv_tail"]},
              tail_max_abs_err=fused_err,
              tail_forms={"f64": fused_cycle(fused64),
                          "f32_bf16": fused_cycle(fused32)},
              # the lattice hierarchies' operators, each whole (its K1
              # launches, its tail, its gather), L2 flushed
              lattice_f64=lattice_rows(lat_rows64),
              lattice_f32_bf16=lattice_rows(lat_rows32),
              # K1 alone at the systems level 0 (19 offsets), with its
              # bound on the nonzero bytes beside the DIA-bytes bound
              systems_level0=k1_sys),
        # one f64 V-cycle's ELL matvecs, each timed alone and summed
        entry("ell_spmv", "hypre_tpu_torch/csrc/ell_spmv.cu",
              "scripts/exp_mosaic_gather.py:52", ell_err, *ell64[:5],
              per="v_cycle", matvecs=per_cycle64,
              forms=form_times(ell_forms64, "v_cycle")),
    ]
    for name, probe, replaces in (
            ("take_along_axis", "K3 grid", "scripts/exp_mosaic_gather.py:65"),
            ("flat_take", "K2 (c) flat", "scripts/exp_mosaic_gather.py:52")):
        t = gather_times[probe]
        extra = {}
        if name == "take_along_axis":
            # the probes' shapes: K2 (a), (b) and K3; on the path: AMG-DD's
            # float32 device cycle, its level-0 gather
            extra = {"probes": {p: gather_times[p] for p in (
                "K2 (a) lanes", "K2 (b) sublanes", "K3 grid")},
                "amgdd": dd_gathers["float32"]}
        if name == "flat_take":
            # on the path: one f64 lattice V-cycle's gathers (bitwise
            # equal to the plain version), beside the probe's shape
            keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "earlier_ms")
            extra = {"v_cycle": dict(zip(keys, take64)), "shapes": take_shapes,
                     "amgdd": dd_gathers["float64"]}
        # ms: the tiled form; earlier_ms: the elementwise form, in turns
        # with it; floor_ms: an empty kernel, in the same turns
        kernels.append(entry(name, "hypre_tpu_torch/csrc/gather.cu", replaces,
                             t["max_abs_err"], t["ms"], t["plain_ms"],
                             t["library_ms"], t["bound_ms"], t["bound_by"],
                             per="launch", earlier_ms=t["earlier_ms"],
                             floor_ms=t["floor_ms"], probe=probe,
                             probe_launches=gather_launches[name], **extra))
    # one f64 lattice V-cycle's tails, each timed alone and summed; the
    # library time is the three-call torch form
    kernels.append(entry("coo_tail", "hypre_tpu_torch/csrc/coo_tail.cu",
                         "hypre_tpu/ops/dia.py:87", tail_err, *tail64[:5],
                         per="v_cycle", entries=tail_entries))
    # the collapsed coarse solve of the f64 lattice path, one launch; the
    # gather it holds is K2 (c)'s in the system (GatherOp,
    # hypre_tpu/ops/dia.py:876-880)
    ms, plain_ms, lib_ms, bms, by, err, un_ms, shape = cell64
    kernels.append(entry("cell_dense", "hypre_tpu_torch/csrc/cell_dense.cu",
                         "scripts/exp_mosaic_gather.py:52", err, ms, plain_ms,
                         lib_ms, bms, by, per="launch", shape=shape,
                         unfused_ms=un_ms, f32=dict(zip(
                             ("ms", "plain_ms", "library_ms", "bound_ms"),
                             cell32[:4]), unfused_ms=cell32[6],
                             shape=cell32[7])))
    # one f64 96^3 V-cycle's 14 sweeps, each timed alone and summed; the
    # JAX package runs a sweep as a lax.scan, no Pallas kernel
    kernels.append({
        "name": "gs_sweep", "route": "cuda",
        "source": "hypre_tpu_torch/csrc/gs_sweep.cu",
        "replaces": "hypre_tpu/solvers/amg/relax.py:174",
        "tpu_form": "lax.scan over the wavefronts, no Pallas kernel",
        "launches": (gs64["launches"]["gs_sweep"] + family_total["gs_sweep"]
                     + sstruct_total["gs_sweep"] + par_total["gs_sweep"]
                     + par_struct_total["gs_sweep"]),
        "path_launches": {**{k: v["launches"]["gs_sweep"]
                             for k, v in gs_runs.items()},
                          **{f"cycles {k}": v["launches"]["gs_sweep"]
                             for k, v in cycles.items()},
                          **{f"agg {k}": v["launches"]["gs_sweep"]
                             for k, v in agg.items()},
                          **{f"device setup {k}": v["launches"]["gs_sweep"]
                             for k, v in ds.items()},
                          **{f"ij {k}": v["launches"]["gs_sweep"]
                             for k, v in ij_runs.items()},
                          "family": family_total["gs_sweep"],
                          "sstruct": sstruct_total["gs_sweep"],
                          "par": par_total["gs_sweep"],
                          "par_struct": par_struct_total["gs_sweep"]},
        "syncfree_launches": {k: v["syncfree_launches"]
                              for k, v in gs_runs.items() if k.startswith("gs")},
        "max_abs_err": gs_err, "ms": gs_tot[0], "earlier_ms": gs_tot[1],
        "plain_ms": gs_tot[2], "bound_ms": gs_tot[4], "bound_by": "bytes",
        "latency_bound_ms": gs_tot[5], "t_step_ns": t_step["ns"],
        "library_ms": gs_tot[3],
        "library_note": (None if gs_tot[3] is not None else gs_lib_why),
        "per": "sweep, summed over one V-cycle's 14",
        "earlier": "the wavefront form (csrc/gs_sweep.cu::gs_sweep_kernel), "
                   "one block or grid as its wrapper picked it",
        "bitwise_wavefront": gs_same,
        "wavefronts": sum(r["wavefronts"] for r in gs_rows),
        "levels": gs_rows, "f32_max_abs_err": gs32_err,
        "cf_and_nonsymmetric": gs_masked, "t_step": t_step})
    require_no_gs_fault(dev, "chip_smoke")
    log(f"chip_smoke: every phase, the builds included, took "
        f"{time.perf_counter() - t_start:.1f} s")
    # the slice's own numbers: entry(), the device RAP, ext+i, the GS
    # family, the device setup chain, the cycle options
    log(json.dumps({"entry": entry_run, "device_rap": {"f64": rap64,
                                                       "f32_bf16": rap32},
                    "ext_i": ext, "gs": gs_runs, "device_setup": ds,
                    "cycles": cycles, "cycles_24": cycles24, "agg": agg,
                    "agg_24": agg24, "air_24": air24, "systems": systems,
                    "systems_24": systems24, "ij": ij_runs,
                    "ij_assembly": ij_asm, "ij_24": ij_small,
                    "family": family, "family_small": family_small,
                    "struct": struct, "sstruct": sstruct, "par": par,
                    "par_struct": par_struct}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
