"""Carry a frozen hierarchy from the JAX package into the port.

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
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.csr import ELLMatrix
from .ops.dia import (DenseMatrix, DIAMatrix, DIAWithTail, GatherOp,
                      ParityInterpOp, ParityRestrictOp, ScatterOp, on_cells,
                      split_interp_tail, tail_on_rows)
from .solvers.amg.boomeramg import AMGLevel
from .solvers.amg.relax import ChebyData, GSSchedule


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


def levels_from_numpy(levels, device) -> list[AMGLevel]:
    """The port's AMGLevels on `device` from hypre_tpu's numpy-leaf
    AMGLevels (DIA, ELL, dense and the lattice forms, the GS schedules
    and the Chebyshev data)."""
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
        ))
    return out
