"""The traced part of a `--trace 1` run, after the window.

Two passes over the same right-hand sides (the traced stream), so the
counting never sits in the profiled time:

1. `count_launches`: the program's kernel entry points, named by the
   modules of `counts/`, are wrapped from here; each call adds its
   needed bytes and wavefronts to its family's tally, then runs as it
   would.
2. `profile`: the solves again under torch.profiler (host and device
   activity), unwrapped.

`Trace` holds what the readers of `metrics/` take: the device events,
the traced wall time, the iterations of the traced solves, and the
launch tallies.  The busy time is the union of the device events'
intervals (the arithmetic of hypre_tpu_torch/profile_slice.py, copied).
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect
import time

import torch

from . import counts


@dataclasses.dataclass
class Trace:
    events: list  # device events: (name, start_us, end_us)
    host: list  # host events: (name, start_us, end_us)
    wall_s: float
    iterations: int
    launches: dict  # family -> {"count", "bytes", "wavefronts"}
    kernel_names: dict  # family -> name fragments of its kernels

    @property
    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.events]) / 1e6

    def family_seconds(self, family: str):
        """Device seconds of the family's kernels, or None when the
        profiler's count of them is not the count of calls (the bytes
        would then be of other launches)."""
        keys = self.kernel_names[family]
        evs = [ev for ev in self.events if any(k in ev[0] for k in keys)]
        if not evs or len(evs) != self.launches[family]["count"]:
            return None
        return sum(e - s for _, s, e in evs) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest
        idle gaps by the host activity that overlaps them most."""
        by_name: dict = {}
        for name, s, e in self.events:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        spans = merged([(s, e) for _, s, e in self.events])
        gaps = sorted(((a[1], b[0]) for a, b in zip(spans, spans[1:])),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for g0, g1 in gaps:
            best, cover = "idle", 0.0
            for name, s, e in self.host:
                c = min(e, g1) - max(s, g0)
                if c > cover:
                    best, cover = name, c
            named.append([best, (g1 - g0) / 1e6])
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": named}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def merged(ranges) -> list:
    """The union of [start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals."""
    return sum(e - s for s, e in merged(ranges))


def count_launches(solve, bs) -> dict:
    """Run solve(b) for each b with every counted entry point wrapped;
    the tallies by family."""
    fams = counts.families()
    cache = counts.OperatorCache()
    tallies = {f: {"count": 0, "bytes": 0, "wavefronts": 0} for f in fams}
    restore = []
    try:
        for fam, mod in fams.items():
            module = importlib.import_module(mod.ENTRY[0])
            orig = getattr(module, mod.ENTRY[1])
            restore.append((module, mod.ENTRY[1], orig))
            setattr(module, mod.ENTRY[1],
                    _counting(orig, mod, tallies[fam], cache))
        for b in bs:
            solve(b)
        _sync()
    finally:
        for module, attr, orig in restore:
            setattr(module, attr, orig)
    return tallies


def _counting(orig, mod, tally: dict, cache):
    sig = inspect.signature(orig)

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        call = sig.bind(*args, **kwargs)
        call.apply_defaults()
        got = mod.launch(call.arguments, cache)
        tally["count"] += 1
        tally["bytes"] += got["bytes"]
        tally["wavefronts"] += got.get("wavefronts", 0)
        return orig(*args, **kwargs)

    return wrapper


def profile(solve, bs, launches: dict) -> Trace:
    """Run solve(b) for each b under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _sync()
    iterations = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for b in bs:
            iterations += solve(b)[1]
        _sync()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.events():
        span = (ev.name, ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        else:
            host.append(span)
    names = {f: mod.KERNEL_NAMES for f, mod in counts.families().items()}
    return Trace(events=dev, host=host, wall_s=wall, iterations=iterations,
                 launches=launches, kernel_names=names)
