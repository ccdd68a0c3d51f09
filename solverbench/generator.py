"""The one traffic generator: it reads a mix's parameters from
`traffic/<mix>.json` and hands the load loop the mix names (`loop`,
`loops/<loop>.py`) its right-hand sides.

A mix states `loop` and the whole-number parameters that loop lists in
its `PARAMS`, each at least 1, and nothing else.

Every vector comes from `--seed` and its place in a stream alone: the
same seed gives the same inputs, and the reference regenerates any of
them.  Streams: the window's solves, the warm-up, the traced solves,
the reference's probe vectors.
"""

from __future__ import annotations

import importlib
import json
import os
import random

import numpy as np
import torch

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "traffic")
WINDOW, WARM, TRACE, PROBE, SAMPLE = range(5)


def load_mix(name: str) -> dict:
    """The parameters of traffic/<name>.json, checked against its loop."""
    with open(os.path.join(TRAFFIC_DIR, f"{name}.json")) as fh:
        mix = json.load(fh)
    loop = loop_of(mix)
    extra = set(mix) - {"loop", *loop.PARAMS}
    if extra:
        raise ValueError(f"traffic {name}: {sorted(extra)} are not "
                         f"parameters of loop {mix['loop']!r}")
    for key in loop.PARAMS:
        if not isinstance(mix.get(key), int) or mix[key] < 1:
            raise ValueError(f"traffic {name}: {key} must be a whole "
                             "number of at least 1")
    return mix


def loop_of(mix: dict):
    """The module of the mix's load loop."""
    return importlib.import_module(f"{__package__}.loops.{mix['loop']}")


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit generator seed for item `index` of `stream` under
    `seed` (any whole number)."""
    words = [seed & (2**64 - 1), stream, index]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


class RHSStream:
    """b of length n, dtype and device fixed, by (stream, index)."""

    def __init__(self, seed: int, n: int, dtype, device):
        self.seed, self.n, self.dtype = seed, n, dtype
        self.device = torch.device(device)

    def vector(self, stream: int, index: int, n: int | None = None,
               dtype=None) -> torch.Tensor:
        """N(0, 1) entries, n of them (the stream's n by default)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, stream, index))
        return torch.randn(self.n if n is None else n, generator=g,
                           dtype=dtype or self.dtype, device=self.device)

    def sampler(self) -> random.Random:
        """The RNG that draws the window's checked solves."""
        return random.Random(stream_seed(self.seed, SAMPLE, 0))


class Reservoir:
    """A uniform sample of k of the window's solves, drawn from the seed
    as they come (the window's length is not known in advance)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1
