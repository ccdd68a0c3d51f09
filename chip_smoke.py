"""Chip smoke test of the PyTorch/CUDA port (hypre_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (csrc/dia_spmv.cu, csrc/ell_spmv.cu,
     csrc/gather.cu; one nvcc each, all at once) and the host setup
     library (csrc/host_kernels.c, cc) from the sources;
  3. hold K1 (the DIA SpMV) against its plain torch version on the card
     at the shapes of the main path and on wide/edge offset sets; time
     both at 96^3, and the cuSPARSE CSR product on the same operator;
     then K1's fused forms (resid, axpy, jacobi) at 96^3 against their
     plain versions, each timed beside the unfused sequence it replaces
     (the plain kernel and torch's elementwise ops);
  4. the gathers (counterparts of the TPU gather probes K2/K3): run the
     probes' four gathers through the kernels, hold each against its
     plain version bitwise, and time each;
  5. the 24^3 f64 slice on the card against the same on the CPU;
  6. the slice in float64 at 96^3: BoomerAMG setup, freeze on the card,
     PCG (two-norm, tol 1e-6, b = ones) -- exactly 25 iterations, the
     hypre oracle count, with K1 carrying the fine-level matvecs and the
     ELL kernel every coarse-level and grid-transfer matvec; then the ELL
     kernel against its plain version on every ELL operator of that
     hierarchy, each timed beside its floor and the cuSPARSE call, and
     every form of it against its plain version on every operator, the
     forms the V-cycle uses timed beside the unfused sequence;
  7. the same with float32 vectors, bfloat16 matrices and
     nongalerkin_tol 0.02 at 96^3 -- 21 +- 1 iterations.
The last two lines are the kernel report and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

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


def slice_options(**kw):
    from hypre_tpu_torch.solvers.amg import BoomerAMGOptions

    return BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False,
        relocate_level2=False, collapse_coarse_n=0, **kw)


def run_slice(nx: int, opts, device):
    """Setup + freeze + PCG on the nx^3 Poisson problem, as a user
    calls it.  Returns (amg, result, setup_s, solve_s); on the card the
    solve is timed with CUDA events, setup with the host clock."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.ops import spmv
    from hypre_tpu_torch.solvers.amg import BoomerAMG
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    dev = torch.device(device)
    t0 = time.perf_counter()
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), opts, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    b = torch.ones(nx**3, dtype=getattr(torch, opts.dtype), device=dev)
    A0 = amg.levels[0].A

    def solve():
        return pcg(lambda x: spmv(A0, x), b, M=amg.precond,
                   opts=PCGOptions(tol=1e-6, max_iter=200, two_norm=True))

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


def phase_gathers(dev, flush, card):
    """The TPU gather probes' four gathers (scripts/exp_mosaic_gather.py
    K2 (a) :35, (b) :43, (c) :52; K3 :65) at their shapes, through the
    kernels, then held bitwise against the plain versions and timed.
    Returns ({kernel: launches}, {probe: (ms, plain_ms, library_ms,
    bound_ms, bound_by, max_abs_err)})."""
    from hypre_tpu_torch.ops.gather_kernel import (
        flat_take_cuda, flat_take_reference, take_along_axis_cuda,
        take_along_axis_reference)

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
        log(f"take_along_axis vs plain [{label}, x {tuple(x.shape)}, idx "
            f"{tuple(i.shape)}, axis {axis}]: bitwise equal")
    ref = flat_take_reference(xf, iF)
    errs["K2 (c) flat"] = float((out_c - ref).abs().max())
    require(torch.equal(out_c, ref), "flat_take differs from its plain version")
    log("flat_take vs plain [K2 (c), table 131072, idx (64, 512)]: "
        "bitwise equal")

    def taa_library(x, i, axis):
        il = i.long()  # take_along_dim takes int64 only; cast outside the timing
        if x.shape == i.shape:
            return lambda: torch.take_along_dim(x, il, dim=axis)
        return lambda: torch.take_along_dim(x.unsqueeze(0), il.view(G, S, L),
                                            dim=2)

    times = {}
    cases = []
    for label, x, i, axis in taa:
        cases.append((label, x.numel(),
                      lambda x=x, i=i, a=axis: take_along_axis_cuda(x, i, a),
                      lambda x=x, i=i, a=axis: take_along_axis_reference(x, i, a),
                      "take_along_dim", taa_library(x, i, axis), i.numel()))
    iF_flat = iF.view(-1)
    cases.append(("K2 (c) flat", xf.numel(), lambda: flat_take_cuda(xf, iF),
                  lambda: flat_take_reference(xf, iF), "index_select",
                  lambda: torch.index_select(xf, 0, iF_flat), iF.numel()))
    for label, tbl, fn, plain, lib_name, lib, ne in cases:
        nbytes = 4 * (2 * ne + tbl)  # idx in, out back, the table once
        bms, by = bound_ms(nbytes, 0, torch.float32)
        ms, plain_ms, lib_ms = (time_cuda_ms(f, flush) for f in (fn, plain, lib))
        times[label] = (ms, plain_ms, lib_ms, bms, by, errs[label])
        log(f"  time [{label}, {ne} gathers; {card}], L2 flushed, median of "
            f"{REPS}: kernel {ms * 1e3:.2f} us = {ms * 1e6 / ne:.4f} ns/elem, "
            f"plain {plain_ms * 1e3:.2f} us, torch {lib_name} "
            f"{lib_ms * 1e3:.2f} us; floor {bms * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB)")
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


def counted_wrappers():
    """{kernel name: its wrapper}; each wrapper's `launches` counts its
    kernel's launches."""
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda
    from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda
    from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda, take_along_axis_cuda

    return {"dia_spmv": dia_spmv_cuda, "ell_spmv": ell_spmv_cuda,
            "take_along_axis": take_along_axis_cuda, "flat_take": flat_take_cuda}


def zero_counts() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


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
    from hypre_tpu_torch.ops import dia_kernel, ell_kernel, gather_kernel

    def timed_build(name, fn):
        t0 = time.perf_counter()
        r = fn()
        return name, time.perf_counter() - t0, r[1] if isinstance(r, tuple) else ""

    jobs = (("dia_spmv.cu", dia_kernel.load), ("ell_spmv.cu", ell_kernel.load),
            ("gather.cu", gather_kernel.load), ("host_kernels.c", native.load))
    with ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(lambda j: timed_build(*j), jobs))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

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
    for name, secs, out in build_all():
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
    gather_launches, gather_times = phase_gathers(dev, flush, card)

    # -- 5. small-input agreement of the whole slice: card vs CPU -----------
    o64 = slice_options(dtype="float64")
    amg_g, res_g, _, _ = run_slice(24, o64, dev)
    amg_c, res_c, _, _ = run_slice(24, o64, "cpu")
    dx = float((res_g.x.cpu() - res_c.x).abs().max() / res_c.x.abs().max())
    log(f"24^3 f64 card vs CPU: iterations {res_g.num_iterations} vs "
        f"{res_c.num_iterations}, max rel diff of x {dx:.3e}")
    require(res_g.num_iterations == res_c.num_iterations == 16 and dx < 1e-9,
            "24^3 slice differs between the card and the CPU")
    del amg_g, amg_c

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
    ell64, ell_err, ell_forms64 = phase_ell(amg, 1e-12, flush, card, "f64")
    del amg, res

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
    phase_ell(amg, 1e-5, flush, card, "bf16/f32")
    del amg, res, flush

    # `launches` counts the f64 96^3 run; "per" says what the times cover
    def entry(name, source, replaces, err, ms, plain_ms, lib_ms, bms, by,
              **per):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": path64[name],
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bms, "bound_by": by, "library_ms": lib_ms, **per}

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
              forms=form_times(k1_forms["96^3 f64"], "launch")),
        # one f64 V-cycle's ELL matvecs, each timed alone and summed
        entry("ell_spmv", "hypre_tpu_torch/csrc/ell_spmv.cu",
              "scripts/exp_mosaic_gather.py:52", ell_err, *ell64[:5],
              per="v_cycle", matvecs=per_cycle64,
              forms=form_times(ell_forms64, "v_cycle")),
    ]
    for name, probe, replaces in (
            ("take_along_axis", "K3 grid", "scripts/exp_mosaic_gather.py:65"),
            ("flat_take", "K2 (c) flat", "scripts/exp_mosaic_gather.py:52")):
        ms, plain_ms, lib_ms, bms, by, err = gather_times[probe]
        kernels.append(entry(name, "hypre_tpu_torch/csrc/gather.cu", replaces,
                             err, ms, plain_ms, lib_ms, bms, by, per="launch",
                             probe=probe, probe_launches=gather_launches[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
