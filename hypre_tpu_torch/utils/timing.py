"""Named-timer registry (port of hypre_tpu/utils/timing.py).

The HYPRE_TIMING named-timer registry (utilities/timing.h:102-108).  A
scope that times work on a CUDA device synchronizes that device before
it reads the clock at both ends, so the wall time covers the device
work and not only its enqueue.
"""

from __future__ import annotations

import contextlib
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

