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
    order per row.
  * bfloat16 leaves keep their bits.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.csr import ELLMatrix
from .ops.dia import DenseMatrix, DIAMatrix
from .solvers.amg.boomeramg import AMGLevel


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _matrix(M, device):
    if M is None:
        return None
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


def levels_from_numpy(levels, device) -> list[AMGLevel]:
    """The port's AMGLevels on `device` from hypre_tpu's numpy-leaf
    AMGLevels (the slice's formats: DIA, ELL, dense)."""
    out = []
    for lvl in levels:
        out.append(AMGLevel(
            A=_matrix(lvl.A, device),
            dinv=_tensor(lvl.dinv, device),
            l1inv=_tensor(lvl.l1inv, device),
            cmask=_tensor(np.asarray(lvl.cmask, dtype=bool), device),
            P=_matrix(lvl.P, device),
            R=_matrix(lvl.R, device),
            coarse_inv=(None if lvl.coarse_inv is None
                        else _tensor(lvl.coarse_inv, device)),
        ))
    return out
