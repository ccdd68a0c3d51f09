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

Between distinct devices a block moves by a peer copy
(`Tensor.to(dst, non_blocking=True)`); on a shared device it is the
block itself (the callers never write into a received block).  Shards
share a device only where the caller asks for it (`make_mesh(devices=
["cpu"] * S)` in the CPU tests, `[f"cuda:{s % count}" ...]` on one
card), as the JAX tests' virtual CPU devices share one CPU.
"""

from __future__ import annotations

import dataclasses

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
