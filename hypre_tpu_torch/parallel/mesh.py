"""The shard mesh and its collectives (port of
hypre_tpu/parallel/mesh.py, the MPI communicator analog).

The JAX package is single-controller: one program drives every shard
of a 1-D `jax.sharding.Mesh`, and `shard_map` bodies talk through
`ppermute` / `psum`.  The port keeps that model: one Python process
drives S shards, each a device of `Mesh.devices`, and a sharded vector
is a tuple of S per-shard blocks, one on each shard's device.  The
collectives below take and return such lists:

  * `ppermute(blocks, perm)`: block s goes to shard d for each (s, d)
    of perm; a shard that is no destination receives zeros (the
    Dirichlet edges of the strip halos rely on it);
  * `psum`, `pmax`: the shards' blocks combined in shard order, the
    result placed on each shard's device;
  * `all_gather`: the blocks concatenated in shard order on each
    shard's device.

`MeshND` (`make_mesh_nd`) arranges the shards in a process grid with
named axes, the JAX package's N-D mesh for the sharded struct stack
(par_struct.py); the collectives see only its flat list of blocks, in
row-major order over the grid.

Between distinct devices a block moves by a peer copy
(`Tensor.to(dst, non_blocking=True)`); on a shared device it is the
block itself (the callers never write into a received block).  Shards
share a device only where the caller asks for it (`make_mesh(devices=
["cpu"] * S)` in the CPU tests, `[f"cuda:{s % count}" ...]` on one
card), as the JAX tests' virtual CPU devices share one CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.errors import arg_error

AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """S shards along one axis; shard s lives on devices[s]."""

    devices: tuple
    axis: str = AXIS

    @property
    def shape(self) -> dict:
        """{axis: S}, as a JAX mesh's `shape`."""
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None,
              axis: str = AXIS) -> Mesh:
    """A mesh of n_devices shards.  With `devices` (any torch device
    names, repeats allowed) shard s lives on devices[s]; otherwise on
    CUDA device s, which must exist: asking for more shards than
    `torch.cuda.device_count()` raises (never a CPU stand-in)."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise arg_error(f"requested {n_devices} shards, gave "
                            f"{len(devs)} devices")
    else:
        have = torch.cuda.device_count()
        n = have if n_devices is None else int(n_devices)
        if n < 1 or n > have:
            raise arg_error(f"requested {n} devices, have {have} CUDA "
                            "devices (pass devices= to place shards)")
        devs = tuple(torch.device("cuda", s) for s in range(n))
    if not devs:
        raise arg_error("a mesh needs at least one shard")
    return Mesh(devices=devs, axis=axis)


@dataclasses.dataclass(frozen=True)
class MeshND:
    """A process grid: prod(dims) shards arranged row-major in an N-D
    grid of `dims`, axis k named axis_names[k] (the JAX package's
    `make_mesh_nd`); shard s, at grid position
    `np.unravel_index(s, dims)`, lives on devices[s].  A class beside
    the 1-D `Mesh`, whose users (par_csr, par_dia, par_amg, dist_setup,
    entry.dryrun_multichip) stay as they are; the collectives below
    take both, since they see only the flat list of blocks.  Only the
    sharded struct stack (par_struct.py) reads the grid."""

    devices: tuple
    dims: tuple
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """{axis name: size} in axis order, as a JAX mesh's `shape`."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh_nd(shape, axes=None, devices=None) -> MeshND:
    """A process grid of `shape` (the struct -P px py pz analog): with
    `devices` (prod(shape) torch device names, repeats allowed) shard s
    lives on devices[s]; otherwise on CUDA device s, and asking for more
    shards than `torch.cuda.device_count()` raises, as `make_mesh` does.
    Axis names default to shard0, shard1, ... (the JAX package's)."""
    dims = tuple(int(p) for p in shape)
    if not dims or min(dims) < 1:
        raise arg_error(f"a process grid needs positive sizes, got {shape}")
    n = int(np.prod(dims))
    names = tuple(axes) if axes else tuple(f"{AXIS}{d}" for d in range(len(dims)))
    if len(names) != len(dims) or len(set(names)) != len(names):
        raise arg_error(f"axis names {names} for a grid of {dims}")
    flat = make_mesh(n, devices)
    return MeshND(devices=flat.devices, dims=dims, axis_names=names)


def default_mesh() -> Mesh:
    return make_mesh()


def _move(t: torch.Tensor, device) -> torch.Tensor:
    return t if t.device == device else t.to(device, non_blocking=True)


def ppermute(blocks, perm) -> list:
    """out[d] = blocks[s] for (s, d) in perm, on shard d's device; zeros
    of shard d's block where no pair names d."""
    out = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = _move(blocks[src], blocks[dst].device)
    return [torch.zeros_like(b) if o is None else o
            for o, b in zip(out, blocks)]


def _reduce(blocks, op) -> list:
    acc = blocks[0]
    for b in blocks[1:]:
        acc = op(acc, _move(b, acc.device))
    return [_move(acc, b.device) for b in blocks]


def psum(blocks) -> list:
    """The sum of the blocks, added in shard order, on every shard."""
    return _reduce(blocks, torch.add)


def pmax(blocks) -> list:
    """The elementwise maximum of the blocks, on every shard."""
    return _reduce(blocks, torch.maximum)


def all_gather(blocks) -> list:
    """The blocks concatenated in shard order (along dim 0), on every
    shard's device; one concatenation a distinct device."""
    cache: dict = {}
    out = []
    for b in blocks:
        if b.device not in cache:
            cache[b.device] = torch.cat([_move(c, b.device) for c in blocks])
        out.append(cache[b.device])
    return out
