"""`gs_sweep`, one Gauss-Seidel sweep of a level
(`hypre_tpu_torch/ops/gs_kernel.py`, `csrc/gs_sweep.cu`).

Bytes: the level matrix's nonzeros in the swept rows, u and f in, the
new u out, and v where the outer weight needs it.  Wavefronts: the longest chain of row dependences of
the level's lower triangle in row order (`wavefronts`), worked out here
from the level's matrix and not read from the program's schedule."""

from __future__ import annotations

import torch

from . import vector_bytes

ENTRY = ("hypre_tpu_torch.solvers.amg.relax", "gs_sweep_cuda")
KERNEL_NAMES = ("gs_sweep",)


def launch(call, cache) -> dict:
    sched, u = call["sched"], call["u"]
    m = sched.mat
    op_bytes, waves = cache.memo(
        ("gs", sched.order.data_ptr(), m.data.data_ptr()),
        lambda: (swept_nonzeros(m.indptr, m.data, sched.order)
                 * m.data.element_size(),
                 wavefronts(m.indptr, m.indices, m.data,
                            m.indptr.numel() - 1)))
    omega = float(call.get("omega", 1.0))
    v = None if omega == 1.0 else (call.get("v") if call.get("v") is not None
                                   else u)
    total = op_bytes + vector_bytes(u, call["f"], u, v)
    return {"bytes": total, "wavefronts": waves}


def swept_nonzeros(indptr: torch.Tensor, data: torch.Tensor,
                   order: torch.Tensor) -> int:
    """Nonzeros of the CSR rows listed in `order`."""
    rows = order.long()
    lens = (indptr[1:] - indptr[:-1]).long()[rows]
    first = torch.repeat_interleave(indptr[:-1].long()[rows], lens)
    within = (torch.arange(int(lens.sum()), device=rows.device)
              - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    return int(torch.count_nonzero(data[first + within]))


def wavefronts(indptr: torch.Tensor, indices: torch.Tensor,
               data: torch.Tensor, n: int) -> int:
    """The length of the longest chain i1 < i2 < ... of rows in which
    each row has a nonzero in the column of the one before: the
    wavefronts a forward sweep in row order takes one after another.
    depth(i) = 1 + max(depth(j) : j < i, a_ij != 0), by relaxing all
    rows at once until nothing changes (as many rounds as wavefronts)."""
    indptr = indptr.long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1])
    cols = indices.long()
    keep = (cols < rows) & (data != 0)
    rows, cols = rows[keep], cols[keep]
    depth = torch.ones(n, dtype=torch.int64, device=indptr.device)
    if rows.numel() == 0:
        return 1 if n else 0
    while True:
        cand = torch.ones_like(depth).scatter_reduce(
            0, rows, depth[cols] + 1, reduce="amax")
        if torch.equal(cand, depth):
            return int(depth.max())
        depth = cand
