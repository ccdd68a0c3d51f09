"""Sharded vectors and reductions (port of
hypre_tpu/parallel/par_vector.py; reference: parcsr_mv/par_vector.c:
InnerProd = local dot + MPI_Allreduce :481-495, the mass variants
batch k dots into one reduction :533-579).

A sharded vector is a tuple of S blocks of `rows_per_shard` entries,
block s on shard s's device, zero past the true length (`pad_vec` /
`unpad`).  The Krylov helpers take tuples of parts
(solvers/krylov/common.py: `tdot` sums the parts' dots in part order on
the first part's device), so `pcg` runs unchanged on sharded vectors,
as it does on the JAX package's padded global arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solvers.krylov.common import tdot
from .mesh import AXIS
from .partition import block_partition


def pad_blocks(v, n_padded: int, devices) -> tuple:
    """Host vector [n] -> S blocks of n_padded / S entries (zero past n),
    block s on devices[s]; v's dtype (bool too)."""
    v = np.asarray(v)
    out = np.zeros(n_padded, dtype=v.dtype)
    out[: len(v)] = v
    per = n_padded // len(devices)
    return tuple(torch.from_numpy(out[s * per:(s + 1) * per].copy()).to(d)
                 for s, d in enumerate(devices))


def unpad_blocks(blocks, n: int) -> np.ndarray:
    """The first n entries of the blocks, in shard order, as numpy."""
    return torch.cat([b.detach().cpu() for b in blocks])[:n].numpy()


class ParVector:
    """A sharded vector's layout: n entries over the mesh's shards."""

    def __init__(self, mesh, n: int, axis: str = AXIS):
        self.mesh = mesh
        self.axis = axis
        self.n = n
        self.part = block_partition(n, mesh.shape[axis])

    def from_host(self, v) -> tuple:
        return pad_blocks(v, self.part.n_padded, self.mesh.devices)

    def to_host(self, blocks) -> np.ndarray:
        return unpad_blocks(blocks, self.n)


def par_dot(x, y) -> torch.Tensor:
    """<x, y>: the shards' dots added in shard order (0-d, on shard 0's
    device)."""
    return tdot(tuple(x), tuple(y))


def par_norm(x) -> torch.Tensor:
    return torch.sqrt(par_dot(x, x))


def par_mass_dot(x, Ys) -> torch.Tensor:
    """k dots against a bundle of k sharded vectors -> [k] (shard 0's
    device), each the shards' partial dots added in shard order."""
    return torch.stack([par_dot(x, Y) for Y in Ys])
