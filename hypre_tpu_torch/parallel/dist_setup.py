"""Distributed (sharded) level-0 AMG setup for lattice (DIA) operators
(port of hypre_tpu/parallel/dist_setup.py).

The reference's setup is MPI-parallel: PMIS exchanges measures and CF
markers through CommPkg halo jobs (par_coarsen.c:2741), interpolation
fetches remote rows (par_csr_matop.c:1655), and the Galerkin product is
hypre_ParMatmul (par_csr_matop.c:277).  For a lattice operator the
single-device shift-algebra chain (solvers/amg/device_coarsen.py::
pmis_impl, ops/device_setup.py::classical_interp_impl / rap_impl) runs
unchanged on every shard, its `shift` replaced by a halo shift (the
neighbours' edge strips, zeros at the global edges, then a local slice)
and its row-max and `any` by global ones.  No shard holds the global
operator: each holds its own columns of the diagonal table, generated
locally as par_laplace.c's GenerateLaplacian builds a rank's rows
(`local_laplacian_dia_block`).

The JAX package runs the bodies in one `shard_map`, every shard in
lockstep.  The port runs shard s's body in a thread of its own
(`run_shards`): the same code on every shard, the collectives meeting
at a barrier, the same order of collectives on every shard because the
loop counts are global.  The sharded chain executes the same elementwise
and shift operations in the same order as the single-image chain, so
the CF split, P and the coarse operator are bitwise the serial device
chain's (`device_pmis`, `device_classical_interp`, `device_rap`).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.device_setup import (_symbolic_offsets, classical_interp_impl,
                                rap_impl)
from ..solvers.amg.device_coarsen import lcg_states_host, pmis_impl
from ..utils.errors import arg_error
from .mesh import AXIS

_PMIS_SEED = 2747


class Rendezvous:
    """All-gather of one Python value a shard among S threads."""

    def __init__(self, S: int):
        self.slots = [None] * S
        self.barrier = threading.Barrier(S)

    def all_gather(self, s: int, value) -> list:
        self.slots[s] = value
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()  # nobody overwrites a slot still being read
        return out


def run_shards(S: int, body) -> list:
    """[body(s, comm) for s in range(S)], each in its own thread, comm a
    shared Rendezvous.  A failing shard breaks the barrier so the others
    stop too; the first real error is raised."""
    comm = Rendezvous(S)
    out = [None] * S
    errors = [None] * S

    def run(s):
        try:
            out[s] = body(s, comm)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors[s] = e
            comm.barrier.abort()

    threads = [threading.Thread(target=run, args=(s,)) for s in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors
            if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]
    if any(e is not None for e in errors):
        raise errors[0]
    return out


def make_halo_shift(comm: Rendezvous, s: int, n_shards: int, n_local: int):
    """shift(x, off, fill) for shard s's 1-D block: values beyond the
    block come from its ring neighbours' edges (non-wraparound: zeros at
    the global edges, the single-image zero fill).  The analog of a
    struct CommPkg ghost exchange (struct_communication.h:18-140) of
    ghost width |off|."""

    def shift(x, off, fill=0):
        off = int(off)
        if off == 0:
            return x
        if not (fill == 0 or fill is False):
            raise NotImplementedError("halo shift supports zero fill only")
        w = abs(off)
        if w > n_local:
            raise arg_error(f"halo width {w} exceeds shard size {n_local}; "
                            "use fewer shards for this offset set")
        edges = comm.all_gather(s, (x[n_local - w:], x[:w]))
        # left halo = the previous shard's last w; right = the next's first w
        left = (edges[s - 1][0].to(x.device) if s > 0
                else x.new_zeros(w))
        right = (edges[s + 1][1].to(x.device) if s < n_shards - 1
                 else x.new_zeros(w))
        return torch.cat([left, x, right])[w + off: w + off + n_local]

    return shift


def _global_any(comm, s):
    return lambda m: any(comm.all_gather(s, bool(m.any())))


def _global_rowmax(comm, s):
    def rowmax(r):
        parts = comm.all_gather(s, r.amax(dim=1))
        acc = parts[0].to(r.device)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.to(r.device))
        return acc

    return rowmax


def dist_lattice_setup(data, offsets, n: int, mesh, axis: str = AXIS, *,
                       seed: int = _PMIS_SEED, theta: float = 0.25,
                       max_row_sum: float = 0.9, trunc_factor: float = 0.0,
                       max_elmts: int = 0, nongalerkin_tol: float = 0.0,
                       dtype=None):
    """The sharded level-0 chain: strength -> PMIS -> classical
    interpolation -> Galerkin RAP, every shard on its device.

    data: the fine operator's row-aligned diagonal table [noff, >= n]
    (numpy, sliced into the shards' columns here) or the S per-shard
    blocks [noff, n / S] (numpy or tensors, e.g. generated locally by
    `local_laplacian_dia_block`); `dtype` casts numpy input (default its
    own).  Returns (cf, P_data, offs_P, A1_data, offs_1): cf the S int8
    blocks [n / S], P_data and A1_data the S blocks [noff, n / S] of
    P's and the coarse operator's tables on the fine lattice; the
    offsets whose P / A1 rows are all zero are dropped, as the serial
    chain drops them."""
    offsets = tuple(int(o) for o in offsets)
    S = mesh.shape[axis]
    if n % S:
        raise arg_error(f"n={n} not divisible by {S} shards")
    n_loc = n // S
    devs = mesh.devices
    if isinstance(data, np.ndarray):
        blocks = [data[:, s * n_loc:(s + 1) * n_loc] for s in range(S)]
    else:
        blocks = list(data)
    blocks = [b if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(b, dtype=dtype or b.dtype)) for b in blocks]
    blocks = [b.to(d) for b, d in zip(blocks, devs)]
    # per-shard Park-Miller states by skip-ahead (random.c:81 order:
    # shard s starts at state seed * a^(s*n_loc+1)), each computed alone
    lcg = [torch.from_numpy(lcg_states_host(seed, n_loc, skip=s * n_loc))
           .to(d) for s, d in enumerate(devs)]

    def stage1(s, comm):
        shift = make_halo_shift(comm, s, S, n_loc)
        cf = pmis_impl(blocks[s], lcg[s], offsets=offsets, n=n_loc,
                       theta=theta, max_row_sum=max_row_sum, shift=shift,
                       any_fn=_global_any(comm, s))
        P_data, rowmaxP = classical_interp_impl(
            blocks[s], cf, offsets=offsets, theta=theta,
            max_row_sum=max_row_sum, trunc_factor=trunc_factor,
            max_elmts=max_elmts, shift=shift,
            rowmax_fn=_global_rowmax(comm, s))
        return cf, P_data, rowmaxP

    res = run_shards(S, stage1)
    cf = [r[0] for r in res]
    rmP = res[0][2].cpu().numpy()
    keep = [k for k in range(len(offsets)) if rmP[k] > 0]
    offs_P = tuple(offsets[k] for k in keep)
    P_data = [r[1][torch.tensor(keep, dtype=torch.long, device=r[1].device)]
              for r in res]

    offs_AP = _symbolic_offsets(offsets, offs_P)
    offs_out = _symbolic_offsets(tuple(-o for o in offs_P), offs_AP)

    def stage2(s, comm):
        return rap_impl(P_data[s], blocks[s], offs_P=offs_P, offs_A=offsets,
                        offs_AP=offs_AP, offs_out=offs_out,
                        tol=float(nongalerkin_tol),
                        shift=make_halo_shift(comm, s, S, n_loc),
                        rowmax_fn=_global_rowmax(comm, s))

    res = run_shards(S, stage2)
    rm = res[0][1].cpu().numpy()
    kept = [k for k, o in enumerate(offs_out) if rm[k] > 0 or o == 0]
    offs_1 = tuple(offs_out[k] for k in kept)
    A1_data = [r[0][torch.tensor(kept, dtype=torch.long, device=r[0].device)]
               for r in res]
    return cf, P_data, offs_P, A1_data, offs_1


def local_laplacian_dia_block(nx, ny, nz, lo, hi, cx=1.0, cy=1.0, cz=1.0,
                              dtype=np.float64):
    """Rows [lo, hi) of the 3D 7-pt Laplacian as a row-aligned diagonal
    block [7, hi - lo] + the global offset list: per-shard local
    generation (par_laplace.c GenerateLaplacian builds only its rank's
    rows)."""
    diag = (2.0 * cx if nx > 1 else 0.0) + (2.0 * cy if ny > 1 else 0.0) \
        + (2.0 * cz if nz > 1 else 0.0)
    live = [(-nx * ny, -cz), (-nx, -cy), (-1, -cx), (0, diag),
            (1, -cx), (nx, -cy), (nx * ny, -cz)]
    live = [(o, v) for o, v in live if v != 0.0 or o == 0]
    idx = np.arange(lo, hi, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    data = np.zeros((len(live), hi - lo), dtype=dtype)
    for k, (off, v) in enumerate(live):
        if off == 0:
            data[k] = v
            continue
        if abs(off) == 1:
            ok = (ix + np.sign(off) >= 0) & (ix + np.sign(off) < nx)
        elif abs(off) == nx:
            ok = (iy + np.sign(off) >= 0) & (iy + np.sign(off) < ny)
        else:
            ok = (iz + np.sign(off) >= 0) & (iz + np.sign(off) < nz)
        data[k] = np.where(ok, v, 0.0)
    return data, tuple(o for o, _ in live)
