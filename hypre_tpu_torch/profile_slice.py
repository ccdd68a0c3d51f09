"""Where the time of one slice solve goes on the card.

    python -m hypre_tpu_torch.profile_slice [--dtype float64|float32] [--lattice]
        [--device-setup] [--relax DOWN UP]

Sets up BoomerAMG-PCG on the 96^3 Poisson problem with the plain forms
(ELL / dense coarse levels), runs one warm-up solve, times 20 solves
with CUDA events (median and spread), then runs one solve under
torch.profiler and prints the device time by kernel, that solve's wall
time and the device's busy and idle shares of it.  float32 runs use
bfloat16 matrices and nongalerkin_tol 0.02, as the production config.
With --lattice the lattice path (the JAX package's option defaults:
level-1 embedding, relocation with tails, coarse collapse) is set up
beside the plain one and the two are measured in turns, plain, lattice,
lattice, plain, each with its setup and FREEZE (with DEVICE_RAP) + COLLAPSE
seconds.  --relax sets relax_down and relax_up (default 18 18, the
bench protocol's l1-Jacobi; 13 14 is BoomerAMGOptions()' Gauss-Seidel,
whose levels the lattice gates decline, so --lattice then measures the
plain forms twice).  --device-setup (implies --lattice) sets the lattice
path up with the device chain, as bench.py does at 96^3 (device_setup,
lattice_coeffs (1, 1, 1)), and prints its DS_* setup phases.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from .models import laplacian_7pt
from .ops import spmv
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .solvers.krylov import PCGOptions, pcg
from .utils.timing import GLOBAL_TIMER


NX = 96
REPEATS = 20
# the device setup chain's timers (BoomerAMG._device_setup_level0)
DS_PHASES = ("DS_SHIP_A0", "DS_PMIS", "DS_INTERP", "DS_RAP", "DS_STATS",
             "DS_A1_PULL", "DS_A1_REBUILD")


def _options(dtype: str, lattice: bool, relax: tuple = (18, 18),
             device_setup: bool = False) -> BoomerAMGOptions:
    extra = ({} if dtype == "float64"
             else dict(mat_dtype="bfloat16", nongalerkin_tol=0.02))
    if lattice:
        # the JAX package's own option defaults (the embedded level-1
        # values from the device RAP)
        extra.update(lattice_shape=(NX, NX, NX))
        if device_setup:
            extra.update(device_setup=True, lattice_coeffs=(1.0, 1.0, 1.0))
    else:
        extra.update(embed_level1=False, relocate_level2=False,
                     collapse_coarse_n=0)
    return BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=relax[0], relax_up=relax[1], dtype=dtype, **extra)


def _setup(dtype: str, lattice: bool, dev, relax=(18, 18),
           device_setup: bool = False):
    """(amg, setup seconds, FREEZE + COLLAPSE seconds), host clock, the
    card synchronized.  FREEZE includes the GS schedules' build
    (GS_SCHEDULE) and the device RAP (DEVICE_RAP)."""
    GLOBAL_TIMER.clear()
    t0 = time.perf_counter()
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    _options(dtype, lattice, relax, device_setup), device=dev)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    freeze_s = sum(GLOBAL_TIMER.seconds(k) for k in ("FREEZE", "COLLAPSE"))
    if device_setup:
        print("device chain phases (s): " + ", ".join(
            f"{k} {GLOBAL_TIMER.seconds(k):.4f}" for k in DS_PHASES))
    return amg, setup_s, freeze_s


def _measure(amg, tag: str, table: bool) -> None:
    """Time REPEATS warm solves, then profile one."""
    dev = amg.device
    b = torch.ones(NX**3, dtype=amg.levels[0].dinv.dtype, device=dev)
    A0 = amg.levels[0].A

    def solve():
        return pcg(lambda x: spmv(A0, x), b, M=amg.precond,
                   opts=PCGOptions(tol=1e-6, max_iter=200, two_norm=True))

    solve()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = solve()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(times)
    print(f"{tag}: solve {med * 1e3:.2f} ms median of "
          f"{len(times)} (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {res.num_iterations} iterations, "
          f"{NX**3 / med:.4g} DOF/s, "
          f"{med / res.num_iterations * 1e3:.3f} ms per iteration")
    res, wall, busy_us, events, prof = profile_solve(solve)
    if table:
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    print(f"{tag}: {res.num_iterations} iterations; "
          f"solve wall {wall * 1e3:.2f} ms under the profiler; device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%), idle "
          f"{100 * (1 - busy_us / 1e6 / wall):.1f}%; {len(events)} device "
          f"events ({len(events) / max(res.num_iterations, 1):.0f} per iteration)")
    # "dia_spmv_" covers K1's row kernel and its offset-lane kernel
    for label, key in (("K1 dia_spmv", "dia_spmv_"),
                       ("K1, the offset-lane kernel alone", "dia_spmv_lanes_kernel"),
                       ("ELL ell_spmv", "ell_spmv_kernel"),
                       ("flat_take", "flat_take_kernel"),
                       ("coo_tail", "coo_tail_kernel"),
                       ("cell_dense", "cell_dense_kernel"),
                       ("gs_sweep (both forms)", "gs_sweep_")):
        mine = [e for e in events if key in e.name]
        us = sum(e.time_range.end - e.time_range.start for e in mine)
        print(f"{tag}: {label}: {len(mine)} launches, "
              f"{us / 1e3:.3f} ms, {100 * us / max(busy_us, 1e-9):.1f}% of "
              f"device busy time")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    ap.add_argument("--lattice", action="store_true",
                    help="also the lattice path, measured in turns with "
                         "the plain one: plain, lattice, lattice, plain")
    ap.add_argument("--device-setup", action="store_true",
                    help="the lattice path with the device setup chain "
                         "(implies --lattice)")
    ap.add_argument("--relax", type=int, nargs=2, default=(18, 18),
                    metavar=("DOWN", "UP"),
                    help="relax_down and relax_up (13 14: Gauss-Seidel)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    dev = torch.device("cuda", 0)
    args.lattice |= args.device_setup
    hierarchies = {}
    for name in ("plain", "lattice") if args.lattice else ("plain",):
        amg, setup_s, freeze_s = _setup(args.dtype, name == "lattice", dev,
                                        tuple(args.relax),
                                        args.device_setup and name == "lattice")
        hierarchies[name] = amg
        print(f"{NX}^3 {args.dtype} relax {args.relax} {name}"
              f"{' (device setup)' if amg._fast is not None else ''}: "
              f"setup {setup_s:.2f} s, of it "
              f"FREEZE + COLLAPSE {freeze_s:.2f} s; "
              f"{len(amg.levels)} levels "
              f"frozen, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
              f"allocated on the card so far")
    turns = (("plain", "lattice", "lattice", "plain") if args.lattice
             else ("plain",))
    seen = set()
    for name in turns:
        _measure(hierarchies[name],
                 f"{NX}^3 {args.dtype} relax {args.relax} {name}",
                 table=name not in seen)
        seen.add(name)


def profile_solve(solve, cpu: bool = True):
    """Run solve() once under torch.profiler.  Returns (its result, wall
    seconds under the profiler, device busy microseconds (the union of
    the device events' intervals), the device events, the profiler).
    cpu=False records the device activity alone, which the profiler
    collects much faster for a solve of 10^4 kernels and more."""
    acts = ([torch.profiler.ProfilerActivity.CPU] if cpu else []) + [
        torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in events])
    return res, wall, busy_us, events, prof


def _union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


if __name__ == "__main__":
    main()
