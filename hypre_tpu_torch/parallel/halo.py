"""Halo exchange plans, the ParCSR CommPkg analog (port of
hypre_tpu/parallel/halo.py; reference: parcsr_mv/
par_csr_communication.h:51-79 send_procs / send_map_elmts /
recv_vec_starts, and new_commpkg.c).

A plan is built once per matrix on the host: a fixed set of neighbour
OFFSETS d on the 1-D shard axis and, per offset, the rows each shard
packs for shard s + d (`send_idx`) and the ghost slots where the values
arriving from shard s - d land (`recv_pos`), every array the JAX
package's, bitwise.  Pads read index `rows_per_shard` (a zero appended
to the block) and write slot `ghost_width` (a sink).  At run time each
offset is one pack (a gather on the sender's device), one
`mesh.ppermute` and one unpack (an indexed write on the receiver's):
pack(send_map_elmts) -> Isend/Irecv -> unpack.  Past `max_offsets`
offsets the plan is a dense all-gather (`ghost_gids`), for coupling
where every shard talks to every shard.

`reverse_exchange` is the transposed communication
(parcsr_mv/communicationT.c): contributions to ghost slots go back to
the owning rows and are combined there, "add" by `index_add_` (atomic
on the card, so a float sum's order may vary there; integer counts are
exact) and "max" by `scatter_reduce(..., "amax")`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.errors import arg_error
from .mesh import all_gather, pmax, ppermute, psum
from .partition import BlockPartition


@dataclasses.dataclass(eq=False)
class HaloPlan:
    """Static exchange plan (built once, like CommPkg).

    Per offset d (python ints `offsets`):
      send_idx[o][s, k]  local row (in shard s) to pack for shard s+d
      recv_pos[o][s, k]  slot in shard s's ghost buffer where the k-th
                         value arriving from shard s-d lands
    numpy int32, the JAX package's arrays; their int64 copies on each
    shard's device are made at first use (`device_index`)."""

    send_idx: tuple  # tuple of int32 [n_shards, W_o]
    recv_pos: tuple  # tuple of int32 [n_shards, W_o]
    offsets: tuple
    ghost_width: int
    use_allgather: bool
    n_shards: int
    ghost_gids: np.ndarray | None = None  # int32 [n_shards, ghost_width]
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def device_index(self, name: str, o: int, s: int, device) -> torch.Tensor:
        """Row s of send_idx[o] / recv_pos[o] / ghost_gids (o ignored) as
        int64 on `device`, made once."""
        key = (name, o, s, device)
        if key not in self._dev:
            arr = (self.ghost_gids if name == "ghost_gids"
                   else getattr(self, name)[o])
            self._dev[key] = torch.from_numpy(
                np.asarray(arr[s], dtype=np.int64)).to(device)
        return self._dev[key]


def build_halo_plan(
    col_map_offd: list,
    part: BlockPartition,
    max_offsets: int = 8,
) -> HaloPlan:
    """col_map_offd[s]: sorted unique global col ids shard s needs
    (excluding its own rows): exactly hypre's col_map_offd."""
    S = part.n_shards
    ghost_width = max((len(c) for c in col_map_offd), default=0)
    ghost_width = max(ghost_width, 1)

    needed_offsets: set[int] = set()
    per_pair: dict = {}
    for s, cm in enumerate(col_map_offd):
        if len(cm) == 0:
            continue
        owners = part.owner(cm)
        for o in np.unique(owners):
            d = (int(s) - int(o)) % S  # sender o, receiver s: permute by d
            needed_offsets.add(d)
            mask = owners == o
            per_pair[(int(o), int(s))] = (
                part.local(cm[mask]).astype(np.int32),
                np.flatnonzero(mask).astype(np.int32),
            )

    if len(needed_offsets) > max_offsets:
        gids = np.full((S, ghost_width), 0, dtype=np.int32)
        for s, cm in enumerate(col_map_offd):
            gids[s, : len(cm)] = cm
        return HaloPlan(send_idx=(), recv_pos=(), offsets=(),
                        ghost_width=ghost_width, use_allgather=True,
                        n_shards=S, ghost_gids=gids)

    offsets = tuple(sorted(needed_offsets))
    send_idx, recv_pos = [], []
    for d in offsets:
        W = max((len(per_pair[(o, (o + d) % S)][0]) for o in range(S)
                 if (o, (o + d) % S) in per_pair), default=0)
        W = max(W, 1)
        sidx = np.full((S, W), part.rows_per_shard, dtype=np.int32)
        rpos = np.full((S, W), ghost_width, dtype=np.int32)
        for o in range(S):
            s = (o + d) % S
            if (o, s) in per_pair:
                sl, rp = per_pair[(o, s)]
                sidx[o, : len(sl)] = sl
                rpos[s, : len(rp)] = rp
        send_idx.append(sidx)
        recv_pos.append(rpos)
    return HaloPlan(send_idx=tuple(send_idx), recv_pos=tuple(recv_pos),
                    offsets=offsets, ghost_width=ghost_width,
                    use_allgather=False, n_shards=S, ghost_gids=None)


def _zeros_row(x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros((1,) + tuple(x.shape[1:]))


def exchange(plan: HaloPlan, blocks) -> list:
    """blocks[s]: shard s's block [rows_per_shard, ...] (trailing dims
    ride along, so whole ELL rows can be shipped: the
    hypre_ParCSRMatrixExtractBExt fetch) -> each shard's ghost buffer
    [ghost_width + 1, ...], the last slot the pad sink (zero)."""
    S = plan.n_shards
    if plan.use_allgather:
        full = all_gather(blocks)
        return [torch.cat([full[s][plan.device_index(
                    "ghost_gids", 0, s, blocks[s].device)], _zeros_row(x)])
                for s, x in enumerate(blocks)]
    ext = [torch.cat([x, _zeros_row(x)]) for x in blocks]
    ghosts = [x.new_zeros((plan.ghost_width + 1,) + tuple(x.shape[1:]))
              for x in blocks]
    for o, d in enumerate(plan.offsets):
        bufs = [e[plan.device_index("send_idx", o, s, e.device)]
                for s, e in enumerate(ext)]
        bufs = ppermute(bufs, [(src, (src + d) % S) for src in range(S)])
        for s, g in enumerate(ghosts):
            g[plan.device_index("recv_pos", o, s, g.device)] = bufs[s]
    return ghosts


def reverse_exchange(plan: HaloPlan, contribs, n_local: int,
                     combine: str = "add") -> list:
    """Each shard's CONTRIBUTIONS to its ghost slots [ghost_width + 1,
    ...] shipped back to the owning shards and combined (add / max)
    into the owners' rows: returns each shard's [n_local, ...] combined
    contribution (zeros where nothing arrived).  S^T column counts and
    the S^T direction of PMIS ride it, and the P^T leg of a distributed
    Galerkin product."""
    if combine not in ("add", "max"):
        raise arg_error(f"unknown combine {combine!r}")
    S = plan.n_shards
    gw = plan.ghost_width
    if plan.use_allgather:
        fulls = []
        for s, c in enumerate(contribs):
            full = c.new_zeros((S * n_local,) + tuple(c.shape[1:]))
            idx = plan.device_index("ghost_gids", 0, s, c.device)
            if combine == "add":
                full.index_add_(0, idx, c[:gw])
            else:
                full.scatter_reduce_(0, _expand(idx, c[:gw]), c[:gw], "amax")
            fulls.append(full)
        fulls = psum(fulls) if combine == "add" else pmax(fulls)
        return [f[s * n_local:(s + 1) * n_local] for s, f in enumerate(fulls)]

    outs = [c.new_zeros((n_local + 1,) + tuple(c.shape[1:])) for c in contribs]
    for o, d in enumerate(plan.offsets):
        # the slots a shard received from offset d carry what it sends
        # back against that offset
        bufs = [c[plan.device_index("recv_pos", o, s, c.device)]
                for s, c in enumerate(contribs)]
        bufs = ppermute(bufs, [((src + d) % S, src) for src in range(S)])
        for s, out in enumerate(outs):
            idx = plan.device_index("send_idx", o, s, out.device)
            if combine == "add":
                out.index_add_(0, idx, bufs[s])
            else:
                out.scatter_reduce_(0, _expand(idx, bufs[s]), bufs[s], "amax")
    return [out[:n_local] for out in outs]


def _expand(idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """idx broadcast over src's trailing dims (scatter_reduce's index)."""
    if src.dim() == 1:
        return idx
    return idx.view((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
