"""The readings the check's limits are set from: the program's on a
dozen seeds and more, and the control's.

    python3 -m solverbench.control --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--device cuda] [--grid nx ny nz]

One set-up of the program, then for each seed the solves a run would
check (`sample` of the mix's, drawn from the seed's stream), each read
by the configuration's check exactly as a run reads it.  The control is
the reference put in the program's place and computed in float32, the
nearest precision below the configuration's float64: its interpolation
weights, its coarse operators and its solves, judged by the float64
reference.
Prints one line of readings a seed and side, then the largest reading
of the program and the smallest of the control for each number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import generator
from .harness import check_module, load_cell, setup, sync


def program_readings(spec, program, ref, seed, device) -> dict:
    check = check_module(spec["config"])
    stream = generator.RHSStream(seed, program.n, torch.float64, device)
    samples = []
    for i in sample_indices(spec, stream):
        b = stream.vector(generator.WINDOW, i)
        x, its, _ = program.solve(b)
        samples.append((b, x, its))
    sync(device)
    return check.verify(ref, program.host_state(), samples, stream)


def control_readings(spec, state, ref, ctrl, seed, device) -> dict:
    """The float32 reference `ctrl` in the program's place: its
    interpolations, coarse operators and solves."""
    check = check_module(spec["config"])
    stream = generator.RHSStream(seed, ref.A0.shape[0], torch.float64, device)
    samples = []
    for i in sample_indices(spec, stream):
        b = stream.vector(generator.WINDOW, i)
        x, its = ctrl.solve(b)
        samples.append((b, x, its))
    fake = {"A": ctrl.operators_scipy(), "P": ctrl.interpolations_scipy(),
            "cf": state["cf"]}
    return check.verify(ref, fake, samples, stream)


def sample_indices(spec, stream, window: int = 100) -> list:
    """The mix's sampled indices, as a run whose window holds `window`
    solves would draw them."""
    loop = generator.loop_of(spec["mix"])
    return loop.sample_indices(stream, spec["mix"], window)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3,
                    help="read the cell at another grid (for sizing)")
    args = ap.parse_args(argv)
    spec = load_cell(args.workload)
    if args.grid:
        cfg = spec["config"]
        i = cfg["line"].index("-n")
        cfg["line"][i + 1:i + 4] = [str(v) for v in args.grid]
        cfg["grid"] = list(args.grid)
    check = check_module(spec["config"])
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    program, phases = setup(spec, dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    print(json.dumps({"grid": spec["config"]["grid"],
                      "setup_s": time.perf_counter() - t0, **phases,
                      "memory_peak_bytes": peak}), flush=True)
    state = program.host_state()
    t0 = time.perf_counter()
    ref = check.Reference(spec["config"], state, device=dev)
    print(json.dumps({"reference_s": time.perf_counter() - t0}), flush=True)
    worst: dict = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = program_readings(spec, program, ref, seed, dev)
        print(json.dumps({"side": "program", "seed": seed, **r,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in r.items():
            worst[k] = max(worst.get(k, v), v)
    program = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    least: dict = {}
    if args.control_seeds:
        ctrl = check.Reference(spec["config"], state, dtype=torch.float32,
                               device=dev)
        for seed in args.control_seeds:
            t0 = time.perf_counter()
            r = control_readings(spec, state, ref, ctrl, seed, dev)
            print(json.dumps({"side": "control", "seed": seed, **r,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            for k, v in r.items():
                least[k] = min(least.get(k, v), v)
    print(json.dumps({"program_largest": worst, "control_smallest": least,
                      "limits": spec["config"]["limits"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
