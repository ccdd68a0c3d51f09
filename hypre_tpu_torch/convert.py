"""Carry a frozen hierarchy, and the struct and sstruct interfaces'
objects, from the JAX package into the port.

`levels_from_numpy` takes hypre_tpu's frozen AMGLevels with every leaf
already a numpy array (e.g. `jax.tree.map(np.asarray, levels)`) and
builds the port's levels on `device`, so both packages can run their
solve phase on the identical hierarchy.  It reads the JAX containers by
their fields and imports neither jax nor hypre_tpu.

Layout changes:
  * DIA: JAX pads `data` to the Pallas grid ([noff, W >= n]); the port
    stores exactly [noff, n].
  * ELL: JAX's device ELL is slot-major [width, n_pad] (`transposed`)
    with n_pad rounded up to 8; the port's is [width, n], same slot
    order per row, int32 cols and both leaves contiguous, as the ELL
    kernel takes them (`ELLMatrix` checks this).
  * bfloat16 leaves keep their bits.
  * Lattice forms (read by class name): a COOTail's `seg` becomes the
    segment pointers and the row pointer the port keeps, and an
    interpolation's tail is also split by parity class (as the port's
    build does); GatherOp keeps int32 positions (the flat_take
    kernel's), ScatterOp gets int64 ones (torch's indexed write), and a
    scatter of a gathered dense operator on one position map becomes the
    port's `on_cells` form; parity matrices lose their padding like any
    DIA; a `coarse_inv` that is an operator (the collapsed sub-cycle) is
    carried as one.
  * GS schedules (a GSSchedule, or a (C, F) tuple of them): the JAX
    package's padded slabs are kept for the plain version as they are,
    and the kernel's layout (CSR, wavefront order and pointers, hazard
    flags) is derived from them (relax.py::GSSchedule.from_slabs).
    Chebyshev data keeps its float64 coefficients and D^{-1/2}.
  * The complex smoothers (smooth_type 9 / 6 / 8): Euclid's triangular
    pair as two GS schedules (from their slabs, as above) with its row
    colors; Schwarz's block pinvs as they are, its row map int64 (the
    pads keep the sink n); ParaSails' G / G^T or M as frozen operators.
  * The sharded solver (parallel/): a HaloPlan's index arrays, a
    ParCSR's host ELL arrays, counts, col maps and row blocks, and a
    ParDIA's per-shard table come across as numpy, as they are; the
    port then lays each shard's operator out on its device of `mesh`
    (`halo_plan_from_numpy`, `par_csr_from_numpy`, `par_dia_from_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.csr import CSRMatrix, ELLMatrix
from .ops.dia import (DenseMatrix, DIAMatrix, DIAWithTail, GatherOp,
                      ParityInterpOp, ParityRestrictOp, ScatterOp, on_cells,
                      split_interp_tail, tail_on_rows)
from .solvers.amg.boomeramg import AMGLevel
from .solvers.amg.euclid import EuclidData
from .solvers.amg.parasails import ParaSailsData
from .solvers.amg.relax import ChebyData, GSSchedule
from .solvers.amg.schwarz import SchwarzData
from .sstruct.grid import SStructGrid, VarType
from .sstruct.matrix import SStructMatrix
from .struct.box import Box
from .struct.grid import StructGrid
from .struct.matrix import StructMatrix
from .struct.multibox import MultiBoxGrid, MultiBoxVector


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tail(T, n_rows: int, device):
    if T is None:
        return None
    rows = np.asarray(T.rows_u, np.int64)[np.asarray(T.seg)]
    return tail_on_rows(rows, _tensor(np.asarray(T.cols, np.int32), device),
                        _tensor(T.vals, device), n_rows)


def _matrix(M, device):
    if M is None:
        return None
    kind = type(M).__name__
    if kind == "DIAWithTail":
        return DIAWithTail(dia=_matrix(M.dia, device),
                           tail=_tail(M.tail, int(M.dia.num_rows), device))
    if kind == "GatherOp":
        return GatherOp(inner=_matrix(M.inner, device),
                        pos=_tensor(np.asarray(M.pos, np.int32), device))
    if kind == "ScatterOp":
        g, pos = M.inner, np.asarray(M.pos, np.int64)
        if (type(g).__name__ == "GatherOp"
                and type(g.inner).__name__ == "DenseMatrix"
                and np.array_equal(np.asarray(g.pos), pos)):
            return on_cells(_matrix(g.inner, device), pos, int(M.n_out), device)
        return ScatterOp(inner=_matrix(M.inner, device),
                         pos=_tensor(np.asarray(M.pos, np.int64), device),
                         n_out=int(M.n_out))
    if kind in ("ParityRestrictOp", "ParityInterpOp"):
        mats = tuple(_matrix(m, device) for m in M.mats)
        shape = tuple(int(s) for s in M.fine_shape)
        factors = tuple(int(f) for f in M.factors)
        if kind == "ParityRestrictOp":
            return ParityRestrictOp(mats=mats, fine_shape=shape,
                                    factors=factors, tail=_tail(
                                        M.tail, mats[0].num_rows, device))
        tail = _tail(M.tail, int(np.prod(shape)), device)
        return ParityInterpOp(
            mats=mats, fine_shape=shape, factors=factors, tail=tail,
            class_tails=(None if tail is None
                         else split_interp_tail(tail, shape, factors)))
    n, m = int(M.num_rows), int(M.num_cols)
    if hasattr(M, "offsets"):  # DIAMatrix
        return DIAMatrix(data=_tensor(np.asarray(M.data)[:, :n], device),
                         offsets=tuple(int(o) for o in M.offsets),
                         num_rows=n, num_cols=m)
    if hasattr(M, "cols"):  # ELLMatrix
        if not M.transposed:
            raise ValueError("expected the device ELL layout [width, n_pad]")
        cols, data = np.asarray(M.cols), np.asarray(M.data)
        return ELLMatrix(cols=_tensor(cols[:, :n].astype(np.int32), device),
                         data=_tensor(data[:, :n], device),
                         num_rows=n, num_cols=m, nnz=int(M.nnz))
    return DenseMatrix(data=_tensor(np.asarray(M.data)[:n, :m], device),
                       num_rows=n, num_cols=m)


def _coarse_inv(ci, device):
    """The dense pinv as a tensor; the collapsed sub-cycle as an operator."""
    if ci is None:
        return None
    if isinstance(ci, np.ndarray) or not hasattr(ci, "num_rows"):
        return _tensor(ci, device)
    return _matrix(ci, device)


def _gs(S, device):
    """A JAX GSSchedule (numpy leaves), or a (C, F) tuple of them."""
    if S is None:
        return None
    if isinstance(S, (tuple, list)):
        return tuple(_gs(s, device) for s in S)
    return GSSchedule.from_slabs(S.rows, S.acols, S.adata, S.dinv, int(S.n),
                                 device)


def _cheby(C, device):
    if C is None:
        return None
    return ChebyData(
        coefs=tuple(float(c) for c in np.asarray(C.coefs, np.float64)),
        dsqrtinv=_tensor(np.asarray(C.dsqrtinv, np.float64), device),
        order=int(C.order))


def _euclid(E, device):
    if E is None:
        return None
    return EuclidData(
        Lsched=_gs(E.Lsched, device), Usched=_gs(E.Usched, device),
        color_of_row=_tensor(np.asarray(E.color_of_row, np.int32), device),
        ncolors=int(E.ncolors), colored=bool(E.colored))


def _schwarz(S, device):
    if S is None:
        return None
    return SchwarzData(inv=_tensor(np.asarray(S.inv, np.float64), device),
                       idx=_tensor(np.asarray(S.idx, np.int64), device),
                       own=_tensor(np.asarray(S.own, bool), device),
                       n=int(S.n))


def _parasails(P, device):
    if P is None:
        return None
    return ParaSailsData(G=_matrix(P.G, device), GT=_matrix(P.GT, device),
                         M=_matrix(P.M, device))


def levels_from_numpy(levels, device) -> list[AMGLevel]:
    """The port's AMGLevels on `device` from hypre_tpu's numpy-leaf
    AMGLevels (DIA, ELL, dense and the lattice forms, the GS schedules,
    the Chebyshev data and the complex smoothers)."""
    out = []
    for lvl in levels:
        out.append(AMGLevel(
            A=_matrix(lvl.A, device),
            dinv=_tensor(lvl.dinv, device),
            l1inv=_tensor(lvl.l1inv, device),
            cmask=_tensor(np.asarray(lvl.cmask, dtype=bool), device),
            P=_matrix(lvl.P, device),
            R=_matrix(lvl.R, device),
            coarse_inv=_coarse_inv(lvl.coarse_inv, device),
            # (a container with only the matrices carries none)
            gs_fwd=_gs(getattr(lvl, "gs_fwd", None), device),
            gs_bwd=_gs(getattr(lvl, "gs_bwd", None), device),
            cheby=_cheby(getattr(lvl, "cheby", None), device),
            euclid=_euclid(getattr(lvl, "euclid", None), device),
            schwarz=_schwarz(getattr(lvl, "schwarz", None), device),
            parasails=_parasails(getattr(lvl, "parasails", None), device),
        ))
    return out


def struct_matrix_from_numpy(M, device) -> StructMatrix:
    """The port's StructMatrix on `device` from hypre_tpu's (its data read
    as numpy, its static fields as they are)."""
    return StructMatrix(
        data=_tensor(np.asarray(M.data), device),
        offsets=tuple(tuple(int(v) for v in o) for o in M.offsets),
        periodic=None if M.periodic is None else tuple(M.periodic),
        const_offsets=tuple(tuple(int(v) for v in o) for o in M.const_offsets),
        const_values=tuple(float(v) for v in M.const_values),
        _shape=None if M._shape is None else tuple(int(s) for s in M._shape),
    )


def multibox_grid_from(G) -> MultiBoxGrid:
    """The port's MultiBoxGrid of hypre_tpu's (box order kept)."""
    return MultiBoxGrid([Box(tuple(b.imin), tuple(b.imax)) for b in G.boxes],
                        periodic=tuple(G.periodic))


def multibox_vector_from(V, device, grid: MultiBoxGrid | None = None
                         ) -> MultiBoxVector:
    """The port's MultiBoxVector on `device` of hypre_tpu's (on `grid`, or
    on the port's copy of its grid)."""
    grid = multibox_grid_from(V.grid) if grid is None else grid
    return MultiBoxVector(grid, {i: _tensor(np.asarray(a), device)
                                 for i, a in V.arrays.items()})


def sstruct_grid_from(G) -> SStructGrid:
    """The port's SStructGrid of hypre_tpu's (its StructGrids' shapes and
    periodicity, its variable types by value)."""
    return SStructGrid(
        parts=tuple(tuple(StructGrid(tuple(int(v) for v in g.shape),
                                     tuple(int(v) for v in g.periodic))
                          for g in pv) for pv in G.parts),
        var_types=tuple(tuple(VarType(t.value) for t in pv)
                        for pv in G.var_types))


def sstruct_matrix_from_numpy(A, device) -> SStructMatrix:
    """The port's SStructMatrix on `device` from hypre_tpu's: each S
    block through `struct_matrix_from_numpy`, U from its host CSR (frozen
    by the port's `freeze_auto`, as the JAX package froze its own)."""
    U = A.u_host
    return SStructMatrix(
        sstruct_grid_from(A.grid),
        {k: struct_matrix_from_numpy(sm, device) for k, sm in A.smats.items()},
        None if U is None else CSRMatrix(np.asarray(U.indptr),
                                         np.asarray(U.indices),
                                         np.asarray(U.data), U.shape),
        device=device)


def sstruct_vector_from(x, device) -> tuple:
    """An sstruct vector (nested tuples [part][var]) of hypre_tpu's as
    tensors on `device`."""
    return tuple(tuple(_tensor(np.asarray(v), device) for v in pv)
                 for pv in x)


def halo_plan_from_numpy(plan):
    """The port's HaloPlan of hypre_tpu's (its index arrays as numpy)."""
    from .parallel.halo import HaloPlan

    gids = getattr(plan, "ghost_gids", None)
    return HaloPlan(
        send_idx=tuple(np.asarray(a) for a in plan.send_idx),
        recv_pos=tuple(np.asarray(a) for a in plan.recv_pos),
        offsets=tuple(int(d) for d in plan.offsets),
        ghost_width=int(plan.ghost_width),
        use_allgather=bool(plan.use_allgather), n_shards=int(plan.n_shards),
        ghost_gids=None if gids is None else np.asarray(gids))


def par_csr_from_numpy(P, mesh):
    """The port's ParCSR of hypre_tpu's, its shards on `mesh`'s devices:
    the host arrays carried, each shard's merged ELL operator built from
    them (parallel/par_csr.py)."""
    from .parallel.par_csr import ParCSR
    from .parallel.partition import BlockPartition

    def part(p):
        return BlockPartition(int(p.n_global), int(p.n_shards),
                              int(p.rows_per_shard))

    out = ParCSR.__new__(ParCSR)
    out.mesh, out.axis = mesh, mesh.axis
    out.n, out.m = int(P.n), int(P.m)
    out.part, out.col_part = part(P.part), part(P.col_part)
    out.host_blocks = list(P.host_blocks)
    out.col_maps = [np.asarray(c) for c in P.col_maps]
    out.plan = halo_plan_from_numpy(P.plan)
    for k in ("diag_cols", "diag_data", "offd_cols", "offd_data"):
        setattr(out, k, np.array(getattr(P, k)))
    out.diag_counts = np.array(P.diag_counts)
    out.offd_counts = np.array(P.offd_counts)
    out._place()
    return out


def par_dia_from_numpy(P, mesh):
    """The port's ParDIA of hypre_tpu's (its [S, noff, per] table)."""
    from .parallel.par_dia import ParDIA
    from .parallel.partition import block_partition

    out = ParDIA.__new__(ParDIA)
    out.mesh, out.axis = mesh, mesh.axis
    out.n = out.m = int(P.n)
    out.offsets = tuple(int(o) for o in P.offsets)
    out.part = out.col_part = block_partition(out.n, mesh.size)
    out.halo = int(P.halo)
    out.data = np.array(P.data)
    out._place()
    return out
