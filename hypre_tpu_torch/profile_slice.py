"""Where the time of one slice solve goes on the card.

    python -m hypre_tpu_torch.profile_slice [--dtype float64|float32]

Sets up BoomerAMG-PCG on the 96^3 Poisson problem (the slice's
configuration), runs one warm-up solve, times 20 solves with CUDA
events (median and spread), then runs one solve under
torch.profiler and prints the device time by kernel, that solve's wall
time and the device's busy and idle shares of it.  float32 runs use
bfloat16 matrices and nongalerkin_tol 0.02, as the production config.
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


NX = 96
REPEATS = 20


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA device")
    dev = torch.device("cuda", 0)
    extra = ({} if args.dtype == "float64"
             else dict(mat_dtype="bfloat16", nongalerkin_tol=0.02))
    opts = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False, relocate_level2=False,
        collapse_coarse_n=0, dtype=args.dtype, **extra)
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device=dev)
    b = torch.ones(NX**3, dtype=getattr(torch, args.dtype), device=dev)
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
    print(f"{NX}^3 {args.dtype}: solve {med * 1e3:.2f} ms median of "
          f"{len(times)} (min {min(times) * 1e3:.2f}, max "
          f"{max(times) * 1e3:.2f}), {res.num_iterations} iterations, "
          f"{NX**3 / med:.4g} DOF/s, "
          f"{med / res.num_iterations * 1e3:.3f} ms per iteration")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = _union_us([(e.time_range.start, e.time_range.end) for e in events])
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    print(f"{NX}^3 {args.dtype}: {res.num_iterations} iterations; "
          f"solve wall {wall * 1e3:.2f} ms under the profiler; device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.1f}%), idle "
          f"{100 * (1 - busy_us / 1e6 / wall):.1f}%; {len(events)} device "
          f"events ({len(events) / max(res.num_iterations, 1):.0f} per iteration)")
    for label, key in (("K1 dia_spmv", "dia_spmv_kernel"),
                       ("ELL ell_spmv", "ell_spmv_kernel")):
        mine = [e for e in events if key in e.name]
        us = sum(e.time_range.end - e.time_range.start for e in mine)
        print(f"{NX}^3 {args.dtype}: {label}: {len(mine)} launches, "
              f"{us / 1e3:.3f} ms, {100 * us / max(busy_us, 1e-9):.1f}% of "
              f"device busy time")


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
