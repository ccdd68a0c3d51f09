"""Chip smoke test of the PyTorch/CUDA port (hypre_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the kernel K1 (csrc/dia_spmv.cu, nvcc) and the host setup
     library (hypre_tpu/native/kernels.c, cc) from the sources;
  3. hold K1 against its plain torch version on the card at the shapes
     of the main path and on wide/edge offset sets; time both at 96^3;
  4. the slice in float64 at 96^3: BoomerAMG setup, freeze on the card,
     PCG (two-norm, tol 1e-6, b = ones) -- exactly 25 iterations, the
     hypre oracle count, with K1 carrying the fine-level matvecs;
  5. the slice with float32 vectors, bfloat16 matrices and
     nongalerkin_tol 0.02 at 96^3 -- 21 +- 1 iterations.
The last two lines are the kernel report and {"ok": true, ...}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

NX = 96
ORACLE_F64 = 25  # hypre 2.20 `ij -laplacian` at 96^3 (BASELINE.md)
PRODUCTION_F32 = 21  # the JAX package's count for the f32/bf16 config
REPS = 50


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


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


def time_cuda(fn, flush: torch.Tensor) -> float:
    """Median ms of fn() over REPS launches, each after an L2 flush
    (write of a buffer larger than the 50 MB L2), timed with CUDA
    events around the call alone."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from hypre_tpu_torch import native
    from hypre_tpu_torch.ops import dia_kernel
    from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them

    # -- 2. builds ---------------------------------------------------------
    t0 = time.perf_counter()
    _, ptxas = dia_kernel.load()
    t_k1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.load()
    t_host = time.perf_counter() - t0
    log(f"build: K1 (nvcc) {t_k1:.2f} s, host kernels (cc) {t_host:.2f} s")
    for line in ptxas.strip().splitlines():
        log(f"  nvcc: {line.strip()}")

    # -- 3. K1 against its plain version ------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    timing = {}
    worst = {}
    for label, data, offs, x, tol in k1_cases(dev):
        offs_t = torch.tensor(offs, dtype=torch.int64, device=dev)
        y = dia_spmv_cuda(data, offs_t, x)
        y_ref = dia_spmv_reference(data, offs, x)
        torch.cuda.synchronize()
        err = float((y - y_ref).abs().max())
        rel = err / max(float(y_ref.abs().max()), 1e-300)
        log(f"K1 vs plain [{label}]: max abs err {err:.3e}, "
            f"rel {rel:.3e} (tol {tol:g})")
        require(rel <= tol, f"K1 disagrees with its plain version on {label}")
        worst[label] = err
        if label.startswith("96^3"):
            n = x.shape[0]
            nbytes = (len(offs) * data.element_size() + 2 * x.element_size()) * n
            ms = time_cuda(lambda: dia_spmv_cuda(data, offs_t, x), flush)
            plain_ms = time_cuda(lambda: dia_spmv_reference(data, offs, x), flush)
            timing[label] = (ms, plain_ms)
            log(f"  time [{label}], L2 flushed, median of {REPS}: "
                f"K1 {ms * 1e3:.1f} us ({nbytes / ms / 1e6:.0f} GB/s), "
                f"plain {plain_ms * 1e3:.1f} us "
                f"({nbytes / plain_ms / 1e6:.0f} GB/s); {nbytes / 1e6:.1f} MB")
    del flush

    # -- small-input agreement of the whole slice: card vs CPU -----------
    o64 = slice_options(dtype="float64")
    amg_g, res_g, _, _ = run_slice(24, o64, dev)
    amg_c, res_c, _, _ = run_slice(24, o64, "cpu")
    dx = float((res_g.x.cpu() - res_c.x).abs().max() / res_c.x.abs().max())
    log(f"24^3 f64 card vs CPU: iterations {res_g.num_iterations} vs "
        f"{res_c.num_iterations}, max rel diff of x {dx:.3e}")
    require(res_g.num_iterations == res_c.num_iterations == 16 and dx < 1e-9,
            "24^3 slice differs between the card and the CPU")

    # -- 4. the slice in f64 at 96^3 ----------------------------------------
    n = NX**3
    GLOBAL_TIMER.clear()
    dia_spmv_cuda.launches = 0
    amg, res, setup_s, solve_s = run_slice(NX, o64, dev)
    launches = dia_spmv_cuda.launches
    log("setup phases, f64 96^3 (host clock; FREEZE synchronizes the card):")
    for line in GLOBAL_TIMER.summary().splitlines():
        log(f"  {line}")
    rel, bound = check_solution(amg, res, n)
    fmts = ", ".join(f"L{k} {type(l.A).__name__[:-6]} {l.A.num_rows}"
                     for k, l in enumerate(amg.levels))
    log(f"slice f64 96^3: levels [{fmts}]; setup {setup_s:.2f} s, solve "
        f"{solve_s:.4f} s ({n / solve_s:.4g} DOF/s), {res.num_iterations} "
        f"iterations, final rel residual {float(res.rel_residual_norm):.3e} "
        f"(true, in f64: {rel:.3e}, bound {bound:.1e}), K1 launches {launches}")
    require(res.converged and res.num_iterations == ORACLE_F64,
            f"f64 slice: {res.num_iterations} iterations, oracle {ORACLE_F64}")
    require(launches > 0, "the f64 slice did not launch K1")

    # -- 5. f32 vectors, bf16 matrices, nongalerkin 0.02 ---------------------
    o32 = slice_options(dtype="float32", mat_dtype="bfloat16",
                        nongalerkin_tol=0.02)
    dia_spmv_cuda.launches = 0
    amg, res, setup_s, solve_s = run_slice(NX, o32, dev)
    launches32 = dia_spmv_cuda.launches
    rel, bound = check_solution(amg, res, n)
    log(f"slice f32/bf16/ngt0.02 96^3: setup {setup_s:.2f} s, solve "
        f"{solve_s:.4f} s ({n / solve_s:.4g} DOF/s), {res.num_iterations} "
        f"iterations (JAX package: {PRODUCTION_F32}), final rel residual "
        f"{float(res.rel_residual_norm):.3e} (true, in f64: {rel:.3e}, bound "
        f"{bound:.1e}), K1 launches {launches32}")
    require(res.converged and abs(res.num_iterations - PRODUCTION_F32) <= 1,
            f"f32/bf16 slice: {res.num_iterations} iterations, "
            f"expected {PRODUCTION_F32} +- 1")
    require(launches32 > 0, "the f32/bf16 slice did not launch K1")

    ms, plain_ms = timing["96^3 f64"]
    log(json.dumps({"kernels": [{
        "name": "dia_spmv",
        "route": "cuda",
        "source": "hypre_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "hypre_tpu/ops/pallas_dia.py:104",
        "launches": launches,
        "max_abs_err": worst["96^3 f64"],
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
