"""The right-hand sides from a seed, and the seeded sample."""

from __future__ import annotations

import random

import torch

from solverbench import generator


def test_same_seed_same_vectors_large_seeds():
    for seed in (0, 7, 2**31 + 17, 3 * 2**40):
        a = generator.RHSStream(seed, 1000, torch.float64, "cpu")
        b = generator.RHSStream(seed, 1000, torch.float64, "cpu")
        assert torch.equal(a.vector(generator.WINDOW, 5),
                           b.vector(generator.WINDOW, 5))


def test_streams_indices_and_seeds_differ():
    s = generator.RHSStream(2**31 + 5, 500, torch.float64, "cpu")
    t = generator.RHSStream(2**31 + 6, 500, torch.float64, "cpu")
    vs = [s.vector(generator.WINDOW, 0), s.vector(generator.WINDOW, 1),
          s.vector(generator.WARM, 0), s.vector(generator.TRACE, 0),
          t.vector(generator.WINDOW, 0)]
    for i in range(len(vs)):
        for j in range(i):
            assert not torch.equal(vs[i], vs[j])
    v = s.vector(generator.WINDOW, 3)
    assert v.dtype == torch.float64 and abs(float(v.mean())) < 0.2
    assert 0.8 < float(v.std()) < 1.2
    assert s.vector(generator.PROBE, 1, 37, torch.float32).shape == (37,)


def test_stream_seed_is_63_bits():
    for seed in (0, 1, 2**31 + 3, 2**63 + 11, -5):
        for idx in (0, 1, 10**6):
            assert 0 <= generator.stream_seed(seed, 0, idx) < 2**63


def test_reservoir_draws_from_the_seed_alone():
    def draw(seed):
        r = generator.Reservoir(3, random.Random(seed))
        for i in range(120):
            r.offer(i)
        return r.items

    assert draw(5) == draw(5) and len(draw(5)) == 3
    assert len({tuple(draw(s)) for s in range(20)}) > 10
    r = generator.Reservoir(3, random.Random(1))
    r.offer("a")
    assert r.items == ["a"]
