"""Row-sharded DIA (diagonal) operator, the gather-free distributed fine
level (port of hypre_tpu/parallel/par_dia.py; reference:
par_csr_matvec.c:22-315, with the diag / offd split degenerated to a
block and two strips because the coupling is banded).

For a lattice stencil the halo a shard needs is a contiguous strip of
its neighbours' boundary rows, as wide as the largest |offset|, h: one
`ppermute` of a fixed strip a side (the struct CommPkg analog) and
shifted multiply-adds on `[left | block | right]`.  On each shard's
device that product is K1 (ops/dia_kernel.py; the plain version on the
CPU), which is square only: the shard holds an operator of per + 2h
rows over `[left | x | right]`, its diagonals zero on the 2h halo rows,
and keeps rows [h, h + per).  That is exact: every tap of a kept row
stays inside [0, per + 2h) when h >= max|offset|.  The 2h extra rows
are work K1 does and throws away (17% at 48^3 on 4 shards).

`data` keeps the JAX package's per-shard table [S, noff, per], bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import to_device, torch_dtype
from ..ops.dia import DIAMatrix, dia_spmv
from ..utils.errors import arg_error
from .mesh import AXIS, default_mesh, ppermute
from .par_vector import pad_blocks, unpad_blocks
from .partition import block_partition


def dia_table(A, dtype=None) -> tuple[np.ndarray, tuple]:
    """(data [noff, n], offsets) of a square scipy / CSRMatrix operator:
    data[k, i] = A[i, i + offsets[k]], 0 where A has no entry; the
    entries' values copied (cast to `dtype` when given)."""
    M = A.to_scipy().tocoo() if hasattr(A, "to_scipy") else A.tocoo()
    n = M.shape[0]
    d = M.col.astype(np.int64) - M.row.astype(np.int64)
    offs = np.unique(d)
    data = np.zeros((len(offs), n), dtype=dtype or M.data.dtype)
    data[np.searchsorted(offs, d), M.row] = M.data
    return data, tuple(int(o) for o in offs)


class ParDIA:
    """A square row-aligned DIA operator sharded over a 1-D mesh.

    Requires the halo width (max |offset|) <= rows_per_shard: the
    diagonals reach at most the adjacent shard, as for lattice stencils
    sharded along the slowest (z) axis."""

    def __init__(self, data, offsets, n: int, mesh=None, axis: str = AXIS,
                 dtype=None):
        self.mesh = mesh or default_mesh()
        self.axis = axis
        self.n = self.m = int(n)
        self.offsets = tuple(int(o) for o in offsets)
        S = self.mesh.shape[axis]
        self.part = block_partition(n, S)
        self.col_part = self.part
        per = self.part.rows_per_shard
        self.halo = int(max((abs(o) for o in self.offsets), default=0))
        if self.halo > per:
            raise arg_error(
                f"halo {self.halo} exceeds shard size {per}: diagonals "
                "reach beyond adjacent shards (use ParCSR)")
        data = np.asarray(data)
        noff = len(self.offsets)
        d = np.zeros((S, noff, per), dtype=dtype or data.dtype)
        src = data[:, : self.n]
        if dtype is not None:
            src = src.astype(dtype)
        for s in range(S):
            lo = s * per
            hi = min(lo + per, self.n)
            if hi > lo:
                d[s, :, : hi - lo] = src[:, lo:hi]
        self.data = d
        self._place()

    @classmethod
    def from_dia(cls, A: DIAMatrix, mesh=None, axis: str = AXIS,
                 dtype=None) -> "ParDIA":
        """From a port DIAMatrix (float32 / float64 data, any device)."""
        return cls(A.data.cpu().numpy(), A.offsets, A.num_rows, mesh, axis,
                   dtype=dtype)

    def _place(self) -> None:
        """Each shard's extended operator (module note) on its device."""
        per = self.part.rows_per_shard
        h = self.h = max(self.halo, 1)
        tdt = torch_dtype(str(self.data.dtype))
        self.ext = []
        for s, dev in enumerate(self.mesh.devices):
            ext = np.zeros((len(self.offsets), per + 2 * h),
                           dtype=self.data.dtype)
            ext[:, h:h + per] = self.data[s]
            self.ext.append(DIAMatrix(data=to_device(ext, tdt, dev),
                                      offsets=self.offsets,
                                      num_rows=per + 2 * h,
                                      num_cols=per + 2 * h))

    def _apply(self, left, x, right) -> tuple:
        h, per = self.h, self.part.rows_per_shard
        return tuple(dia_spmv(E, torch.cat([lt, xs, rt]))[h:h + per]
                     for E, lt, xs, rt in zip(self.ext, left, x, right))

    # ------------------------------------------------------------------
    def matvec(self, x) -> tuple:
        """The strips from the neighbours (zeros at the global edges,
        the Dirichlet truncation), then one K1 launch a shard."""
        S = self.mesh.shape[self.axis]
        h = self.h
        left = ppermute([xs[-h:] for xs in x], [(s, s + 1) for s in range(S - 1)])
        right = ppermute([xs[:h] for xs in x], [(s + 1, s) for s in range(S - 1)])
        return self._apply(left, x, right)

    @property
    def matvec_fn(self):
        return self.matvec

    def kernel_launches(self) -> dict:
        """{kernel: launches} of one product on CUDA tensors (either
        `matvec` or `diag_matvec`): one K1 launch a shard."""
        return {"dia_spmv": self.mesh.size}

    def diag_matvec(self, x) -> tuple:
        """The within-shard product: the strips read as zero (the
        hybrid-GS diagonal-block split)."""
        zeros = [xs.new_zeros(self.h) for xs in x]
        return self._apply(zeros, x, zeros)

    @property
    def diag_matvec_fn(self):
        return self.diag_matvec

    # ------------------------------------------------------------------
    def pad_vec(self, v) -> tuple:
        return pad_blocks(v, self.part.n_padded, self.mesh.devices)

    pad_col_vec = pad_vec

    def unpad(self, y) -> np.ndarray:
        return unpad_blocks(y, self.n)
