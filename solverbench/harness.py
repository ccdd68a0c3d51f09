"""One run of one cell: set-up, the measured window, the traced solves,
the check against the reference, and the result line.

Everything a cell needs is found by name: its entry in BENCHMARK.json;
`configs/<config>.json`, which names the program's set-up
(`programs/<program>.py`) and the comparison (`reference/<check>.py`)
and holds what they read; `traffic/<mix>.json`, which names its load
loop (`loops/<loop>.py`, read by `generator.py`); and one reader a
metric in `metrics/<metric>.py`.  A later cell, mix, program, check or
metric is a file of its own and an entry in BENCHMARK.json.
"""

from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time

import torch

from . import generator

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "hypre_tpu")


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(workload: str, bench: dict | None = None) -> dict:
    """{"cell", "config", "mix", "end_to_end", "per_layer"} of a
    workload named in BENCHMARK.json."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = load_json(os.path.join(BENCH_DIR, "configs",
                                    f"{cell['config']}.json"))
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in moved]
    return {"cell": cell, "config": config,
            "mix": generator.load_mix(cell["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, each compared whole (hypre_tpu_torch is not hypre_tpu)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def setup(spec: dict, device):
    """The program's set-up for the cell's configuration:
    (program, {phase: seconds})."""
    config = spec["config"]
    module = importlib.import_module(f"{__package__}.programs."
                                     f"{config['program']}")
    return module.setup(config, device)


def check_module(config: dict):
    """The comparison the configuration names (`reference/<check>.py`)."""
    return importlib.import_module(f"{__package__}.reference."
                                   f"{config['check']}")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             wrap_solve=None) -> dict:
    """One run; returns the result's fields ("correct", "attempted",
    "failed", "metrics", "device", maybe "breakdown", and "checks").

    wrap_solve: a function of the program's solve that returns the
    solve the window runs (the tests plant faults with it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    config, mix = spec["config"], spec["mix"]
    loop = generator.loop_of(mix)
    check = check_module(config)
    program, phases = setup(spec, dev)
    solve = program.solve if wrap_solve is None else wrap_solve(program.solve)
    stream = generator.RHSStream(seed, program.n,
                                 getattr(torch, config["precision"]), dev)
    loop.warm(solve, stream, mix)
    sync(dev)
    setup_s = time.perf_counter() - t_start

    win = loop.window(solve, stream, seconds, mix, lambda: sync(dev))
    times, iters = win.solve_s, win.iterations
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    t_check = time.perf_counter()
    traced = None
    if trace:
        from . import trace as tracing
        bs = loop.trace_inputs(stream, mix)
        launches = tracing.count_launches(solve, bs)
        traced = tracing.profile(solve, bs, launches)
        print(f"solverbench: traced {len(bs)} solves, {traced.iterations} "
              f"iterations, wall {traced.wall_s:.6f} s, device busy "
              f"{traced.busy_s:.6f} s, launches {launches}", file=sys.stderr)

    # the check, with the program's device state freed
    state = program.release()
    del program, solve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    samples = [(stream.vector(generator.WINDOW, j), x, its)
               for j, x, its in win.samples]
    t_ref = time.perf_counter()
    ref = check.Reference(config, state, device=dev)
    values = check.verify(ref, state, samples, stream)
    correct, table = check.judge(values, config["limits"])
    print(f"solverbench: set-up {setup_s:.3f} s, window {win.window_s:.3f} s "
          f"({len(times)} solves), trace {t_ref - t_check:.3f} s, check "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if times:
        q = [times[k * len(times) // 4:(k + 1) * len(times) // 4] or times
             for k in range(4)]
        print("solverbench: iterations mean {:.3f} (min {}, max {}); ms a "
              "solve by quarter of the window: {}".format(
                  sum(iters) / len(iters), min(iters), max(iters),
                  " ".join(f"{1e3 * sum(p) / len(p):.3f}" for p in q)),
              file=sys.stderr)

    run = Run(setup={"setup_s": setup_s, **phases}, solve_s=times,
              iterations=iters, window_s=win.window_s, trace=traced,
              device_kind=device_info(dev, peak, None)["kind"])
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for m in names:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": len(times),
           "failed": win.failed, "metrics": metrics,
           "device": device_info(dev, peak, traced)}
    if traced is not None:
        out["breakdown"] = traced.breakdown()
    out["checks"] = table
    return out


class Run:
    """What a metric reader reads: the set-up's phases, the window's
    solves and, in a traced run, the trace."""

    def __init__(self, setup, solve_s, iterations, window_s, trace,
                 device_kind):
        self.setup, self.solve_s, self.iterations = setup, solve_s, iterations
        self.window_s, self.trace = window_s, trace
        self.device_kind = device_kind


def read_metric(name: str, run: Run):
    """metrics/<name>.py's read(run): a number, or None when the run has
    nothing for it."""
    mod = importlib.import_module(f"{__package__}.metrics.{name}")
    return mod.read(run)


def device_info(dev, peak: int, traced) -> dict:
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
    if traced is not None:
        info["busy_s"] = traced.busy_s
        info["window_s"] = traced.wall_s
    return info
