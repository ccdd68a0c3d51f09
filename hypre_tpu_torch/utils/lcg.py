"""Park-Miller minimal-standard LCG, bit-exact with the reference RNG
(port of hypre_tpu/utils/lcg.py).

The reference (utilities/random.c:41-110) uses x_{k+1} = 16807 * x_k mod
(2^31 - 1), returning x/m in (0, 1].  PMIS coarsening adds one of these
per matrix row to break ties (par_indepset.c:33-62, seed 2747), so
reproducing hypre's coarse grids requires this exact sequence.  x_k =
x_0 * a^k mod m, so a block of values comes from vectorized modular
exponentiation instead of a sequential loop.
"""

from __future__ import annotations

import numpy as np

A = 16807
M = 2147483647  # 2^31 - 1

# a^(2^j) mod m
_POW2: list[int] = []
_x = A
for _ in range(62):
    _POW2.append(_x)
    _x = (_x * _x) % M


def _clamp_seed(seed: int) -> int:
    if seed < 1:
        return 1
    if seed >= M:
        return M - 1
    return int(seed)


def lcg_skip(seed: int, k: int) -> int:
    """State after k steps from `seed` (k=0 returns seed itself)."""
    x = _clamp_seed(seed)
    j = 0
    while k:
        if k & 1:
            x = (x * _POW2[j]) % M
        k >>= 1
        j += 1
    return x


def lcg_fill(seed: int, n: int, skip: int = 0) -> np.ndarray:
    """The n reals hypre_Rand() yields after `skip` draws, i.e.
    hypre_SeedRand(seed); skip x hypre_Rand(); then n further draws."""
    if n == 0:
        return np.empty(0, dtype=np.float64)
    x0 = lcg_skip(seed, skip + 1)  # first returned value is one step past seed
    k = np.arange(n, dtype=np.uint64)
    x = np.full(n, x0, dtype=np.uint64)
    for j in range(64):
        bit = np.uint64(1) << np.uint64(j)
        if (n - 1) >> j == 0:
            break
        sel = (k & bit) != 0
        if sel.any():
            x[sel] = (x[sel] * np.uint64(_POW2[j])) % np.uint64(M)
    return x.astype(np.float64) / M


class HypreLCG:
    """Stateful scalar interface mirroring hypre_SeedRand/hypre_Rand."""

    def __init__(self, seed: int = 13579):
        self.state = _clamp_seed(seed)

    def seed(self, seed: int) -> None:
        self.state = _clamp_seed(seed)

    def rand_i(self) -> int:
        self.state = (self.state * A) % M
        return self.state

    def rand(self) -> float:
        return self.rand_i() / M
