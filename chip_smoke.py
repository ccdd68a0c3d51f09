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
     of 20, device busy and kernels an iteration; setup by phase (DS_*)
     and time to a first solution, medians of 3, in turns with the host
     setup and the plain path.
The last three lines are the slice's numbers (entry, device RAP, ext+i,
the GS family, the device setup chain), the kernel report and
{"ok": true, ...}.
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


def make_solve(amg, nx: int):
    """The bench protocol's solve over a hierarchy: PCG, two-norm test,
    tol 1e-6, b = ones."""
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    b = torch.ones(nx**3, dtype=amg.levels[0].dinv.dtype, device=amg.device)
    A0 = amg.levels[0].A
    return lambda: pcg(lambda x: spmv(A0, x), b, M=amg.precond,
                       opts=PCGOptions(tol=1e-6, max_iter=200, two_norm=True))


def run_slice(nx: int, opts, device):
    """Setup + freeze + PCG on the nx^3 Poisson problem, as a user
    calls it.  Returns (amg, result, setup_s, solve_s); on the card the
    solve is timed with CUDA events, setup with the host clock."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.solvers.amg import BoomerAMG

    dev = torch.device(device)
    t0 = time.perf_counter()
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), opts, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    solve = make_solve(amg, nx)
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
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_reference

    x = res.x
    require(x.shape == (n,), f"solution shape {tuple(x.shape)}")
    require(bool(torch.isfinite(x).all()), "non-finite solution")
    A0 = amg.levels[0].A
    d64, x64 = A0.data.double(), x.double()
    b = torch.ones_like(x64)
    r = b - dia_spmv_reference(d64, A0.offsets, x64)
    nb = float(torch.linalg.vector_norm(b))
    rel = float(torch.linalg.vector_norm(r)) / nb
    bound = 1e-6 + 4 * torch.finfo(x.dtype).eps * float(
        d64.abs().sum(0).max()) * float(torch.linalg.vector_norm(x64)) / nb
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


def phase_hold_operators(amg, tol, label):
    """Every operator of a frozen hierarchy (plain or lattice forms) in
    each form the V-cycle runs it (CYCLE_FORMS; the coarse solve plain)
    through its wrappers, against the plain version on the same inputs
    (`plain_spmv`, then the torch epilogue): relative error within tol
    (1e-4 for a dense product in float32, whose dot products run to
    thousands of terms), the same bits on a second run, and the launches
    of each application exactly what `kernel_launches` says of it.  So
    K1 (with and without a tail), the ELL kernel, `flat_take` and
    `cell_dense` are held at the shapes this hierarchy gives them.
    Untimed.  Returns {"applications", "max_rel", "launches"}: the
    launches of these comparisons, not of a solve."""
    from hypre_tpu_torch.ops import dia as D
    from hypre_tpu_torch.ops.forms import epilogue

    rng = np.random.default_rng(41)
    vdt = amg.levels[0].dinv.dtype
    dev = amg.levels[0].dinv.device
    n_apps, worst = 0, 0.0
    total = {name: 0 for name in read_counts()}
    for name, A, n_in, n_out, _ in cycle_operators(amg):
        fmt = describe(A)[0]
        x = torch.from_numpy(rng.standard_normal(n_in)).to(dev, vdt)
        want = {k: v for k, v in D.kernel_launches(A).items() if v}
        op_tol = (max(tol, 1e-4) if "dense" in fmt and vdt == torch.float32
                  else tol)
        for form in CYCLE_FORMS.get(name.split()[-1], ("plain",)):
            ops = form_operands(form, n_out, vdt, dev, rng)
            zero_counts()
            y = D._spmv_form(A, x, form, **ops)
            counts = read_counts()
            y_ref = epilogue(form, plain_spmv(A, x), x, **ops)
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
            require(torch.equal(D._spmv_form(A, x, form, **ops), y),
                    f"{label} {name} {form}: other bits on a second run")
            for k, v in counts.items():
                total[k] += v
            n_apps += 1
            worst = max(worst, rel)
    log(f"operators [{label}]: {n_apps} applications (every operator in the "
        f"cycle's forms) agree with their plain versions, max rel "
        f"{worst:.2e} (tol {tol:g}), launches as `kernel_launches` says: "
        f"{ {k: v for k, v in total.items() if v} }")
    return {"applications": n_apps, "max_rel": worst,
            "launches": {k: v for k, v in total.items() if v}}


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
    (phase 11 gives medians of 3 of the whole setup; the hierarchy ends
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
    _, wall, busy_us, events, _ = profile_solve(make_solve(amg, nx))
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
DS_ROUNDS = 3  # setups a path for the medians


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
    its CPU run (`hold_chain_on_cpu`); the solve's median of 20 warm
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
        solve = make_solve(amg, NX)
        solve()
        times = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            solve()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        _, wall, busy_us, events, _ = profile_solve(solve)
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
            f"{bound:.1e}); solve median of 20 {o['solve_median_ms']:.2f} ms "
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
    _, wall, busy_us, events, _ = profile_solve(make_solve(amg, nx))
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


def card_vs_cpu(nx, opts, dev, label, want_its):
    """The nx^3 solve on the card (counts at 0 before, read after: as the
    hierarchy says) and on the CPU: both the JAX package's count, the
    final relative residuals within 1e-10 of each other, x within
    1e-9."""
    zero_counts()
    amg_g, res_g, _, solve_s = run_slice(nx, opts, dev)
    counts = read_counts()
    require_no_gs_fault(dev, f"{label} card solve")
    expected = expected_launches(amg_g, res_g.num_iterations)
    amg_c, res_c, _, cpu_s = run_slice(nx, opts, "cpu")
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
    return {"iterations": res_g.num_iterations, "rel_residual_norm": rg,
            "cpu_rel_residual_norm": rc, "solve_s": solve_s,
            "launches": counts}


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

    # `launches` counts the two f64 96^3 runs, the plain path's and the
    # lattice path's, each driven with the counts at 0 just before and
    # read just after; "per" says what the times cover
    def entry(name, source, replaces, err, ms, plain_ms, lib_ms, bms, by,
              **per):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": path64[name] + lat64[name],
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
                                     for k, v in gs_runs.items()}},
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
              lattice_f32_bf16=lattice_rows(lat_rows32)),
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
            # the probes' shapes: K2 (a), (b) and K3
            extra = {"probes": {p: gather_times[p] for p in (
                "K2 (a) lanes", "K2 (b) sublanes", "K3 grid")}}
        if name == "flat_take":
            # on the path: one f64 lattice V-cycle's gathers (bitwise
            # equal to the plain version), beside the probe's shape
            keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "earlier_ms")
            extra = {"v_cycle": dict(zip(keys, take64)), "shapes": take_shapes}
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
        "launches": gs64["launches"]["gs_sweep"],
        "path_launches": {**{k: v["launches"]["gs_sweep"]
                             for k, v in gs_runs.items()},
                          **{f"device setup {k}": v["launches"]["gs_sweep"]
                             for k, v in ds.items()}},
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
    # family, the device setup chain
    log(json.dumps({"entry": entry_run, "device_rap": {"f64": rap64,
                                                       "f32_bf16": rap32},
                    "ext_i": ext, "gs": gs_runs, "device_setup": ds}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
