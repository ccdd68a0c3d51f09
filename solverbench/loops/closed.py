"""One closed-loop caller: each solve is called when the one before it
has returned, back to back, every b fresh from the seed (N(0, 1) in
every entry, made on the device) and every solve from x = 0.

Parameters of the mix:
  warm_solves   solves of set-up that warm the window's call
  sample        solves of the window drawn from the seed whose answers
                the reference checks
  trace_solves  solves a traced run profiles after its window
"""

from __future__ import annotations

import dataclasses
import time

from .. import generator

PARAMS = ("warm_solves", "sample", "trace_solves")


@dataclasses.dataclass
class Window:
    solve_s: list  # host seconds of each solve, call to x synchronized
    iterations: list
    failed: int  # solves that did not converge within max_iter
    window_s: float
    samples: list  # (index, x, iterations) of the sampled solves


def warm(solve, stream, mix) -> None:
    for k in range(mix["warm_solves"]):
        solve(stream.vector(generator.WARM, k))


def window(solve, stream, seconds: float, mix, sync) -> Window:
    times, iters, failed = [], [], 0
    sample = generator.Reservoir(mix["sample"], stream.sampler())
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        b = stream.vector(generator.WINDOW, i)
        sync()
        t0 = time.perf_counter()
        x, its, converged = solve(b)
        sync()
        times.append(time.perf_counter() - t0)
        iters.append(its)
        failed += not converged
        sample.offer((i, x, its))
        i += 1
    return Window(times, iters, failed, time.perf_counter() - w0,
                  sample.items)


def trace_inputs(stream, mix) -> list:
    return [stream.vector(generator.TRACE, k)
            for k in range(mix["trace_solves"])]


def sample_indices(stream, mix, solves: int) -> list:
    """The indices `window` would sample from a window of `solves`
    solves (the control reads the same ones)."""
    res = generator.Reservoir(mix["sample"], stream.sampler())
    for i in range(solves):
        res.offer(i)
    return sorted(res.items)
