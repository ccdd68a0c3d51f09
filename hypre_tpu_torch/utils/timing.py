"""Named-timer registry (port of hypre_tpu/utils/timing.py), and the
kernel timer of the port's measurement scripts.

The HYPRE_TIMING named-timer registry (utilities/timing.h:102-108).  A
scope that times work on a CUDA device synchronizes that device before
it reads the clock at both ends, so the wall time covers the device
work and not only its enqueue.

`time_cuda_ms` times one call on the card with the L2 flushed, as
chip_smoke.py and lane_sweep.py report it.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict

import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Accumulating wall-clock registry: begin/end by name, print summary."""

    def __init__(self):
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self._start: dict[str, float] = {}

    def begin(self, name: str, device=None) -> None:
        _sync(device)
        self._start[name] = time.perf_counter()

    def end(self, name: str, device=None) -> None:
        _sync(device)
        t0 = self._start.pop(name, None)
        if t0 is not None:
            self._acc[name] += time.perf_counter() - t0
            self._count[name] += 1

    @contextlib.contextmanager
    def scope(self, name: str, device=None):
        self.begin(name, device)
        try:
            yield
        finally:
            self.end(name, device)

    def seconds(self, name: str) -> float:
        """Accumulated wall seconds of a named phase (0 if never timed)."""
        return self._acc.get(name, 0.0)

    def summary(self) -> str:
        lines = ["=" * 50, f"{'phase':<24}{'wall (s)':>12}{'calls':>8}", "-" * 50]
        for name, acc in sorted(self._acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{acc:>12.4f}{self._count[name]:>8}")
        lines.append("=" * 50)
        return "\n".join(lines)

    def clear(self) -> None:
        self._acc.clear()
        self._count.clear()
        self._start.clear()


GLOBAL_TIMER = Timer()


@contextlib.contextmanager
def timed(name: str, device=None):
    """Time a named phase in GLOBAL_TIMER; pass `device` when the phase
    runs CUDA work."""
    with GLOBAL_TIMER.scope(name, device):
        yield

# cycles of the sleep kernel before each timed call (~1 ms on the H100)
LEAD_CYCLES = 2_000_000
REPS = 50  # timed calls a median


def time_cuda_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """Median ms of fn() on the card over `reps` calls, after 5 warm-up
    calls.  Before each call `flush` (larger than the 50 MB L2) is
    written, then a sleep kernel of LEAD_CYCLES keeps the card busy
    while the host enqueues fn, so the CUDA events around the call see
    device time and not host latency."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)
