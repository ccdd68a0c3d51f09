"""Row partitioning (port of hypre_tpu/parallel/partition.py; reference:
seq_mv/genpart.c hypre_GeneratePartitioning and the assumed partition,
par_csr_assumed_part.c).

Shards are equal-size row blocks padded to a common length: the assumed
partition is the actual partition, so the owner of a row is
global_row // rows_per_shard.  `rows_per_shard` is rounded up to a
multiple of 8, so at a small n on many shards the trailing shards can
be short or empty (`shard_rows(s)` empty); `owner` clamps to the last
shard.  Pure numpy, the JAX package's arithmetic exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class BlockPartition:
    n_global: int  # true number of rows
    n_shards: int
    rows_per_shard: int  # padded equal block size

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.rows_per_shard

    def owner(self, gid):
        return np.minimum(
            np.asarray(gid) // self.rows_per_shard, self.n_shards - 1
        )

    def local(self, gid):
        return np.asarray(gid) - self.owner(gid) * self.rows_per_shard

    def shard_rows(self, s: int) -> range:
        lo = s * self.rows_per_shard
        return range(lo, min(lo + self.rows_per_shard, self.n_global))


def block_partition(n: int, n_shards: int, multiple: int = 8) -> BlockPartition:
    per = -(-n // n_shards)
    per = ((per + multiple - 1) // multiple) * multiple
    return BlockPartition(n_global=n, n_shards=n_shards, rows_per_shard=per)
