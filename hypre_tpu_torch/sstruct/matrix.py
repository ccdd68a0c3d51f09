"""Semi-structured matrices: S-part (stencils) + U-part (unstructured)
(port of hypre_tpu/sstruct/matrix.py).

Reference: sstruct_mv/sstruct_matrix.{c,h} (sstruct_matrix.h:21-76 —
structured couplings per part/var-pair stored as StructMatrices, all
other entries in one ParCSR U-matrix) and sstruct_matvec.c (dispatch
over S and U parts).

The S blocks are the port's StructMatrices (`struct_matvec`); the U
matrix is kept on the host as CSR and frozen by `freeze_auto` onto the
device: a U whose entries lie on few diagonals (the two-part layouts'
interface planes) becomes a DIA matrix, whose matvec is K1 on the card.
"""

from __future__ import annotations

from typing import Optional

import scipy.sparse as sp
import torch

from ..ops.csr import CSRMatrix, torch_dtype
from ..ops.dia import freeze_auto, spmv
from ..struct.matrix import StructMatrix, struct_matvec
from .grid import SStructGrid
from .vector import pack_vector, unpack_vector


class SStructMatrix:
    """smats[(part, vi, vj)] -> StructMatrix (intra-part stencils);
    umat: global CSR over the concatenated unknown ordering (inter-part
    couplings + arbitrary graph entries), frozen with freeze_auto on
    `device` in `dtype` (the CSR's own by default)."""

    def __init__(
        self,
        grid: SStructGrid,
        smats: dict,
        umat: Optional[CSRMatrix] = None,
        dtype=None,
        *,
        device="cuda",
    ):
        self.grid = grid
        self.smats = dict(smats)
        self.u_host = umat
        self.umat = None
        self.device = torch.device(device)
        if umat is not None and umat.nnz > 0:
            dt = torch_dtype(dtype if dtype is not None
                             else umat.data.dtype.name)
            self.umat = freeze_auto(umat, dt, self.device)

    def diag_block(self, part: int, var: int = 0) -> StructMatrix:
        return self.smats[(part, var, var)]

    def to_scipy(self) -> sp.csr_matrix:
        """Assemble the full monolithic matrix (testing / oracle checks)."""
        n = self.grid.total_size
        offs = self.grid.offsets()
        M = sp.coo_matrix((n, n))
        blocks = []
        for (p, vi, vj), sm in self.smats.items():
            B = sm.to_scipy().tocoo()
            blocks.append(
                sp.coo_matrix(
                    (B.data, (B.row + offs[(p, vi)], B.col + offs[(p, vj)])),
                    shape=(n, n),
                )
            )
        M = sum(blocks) if blocks else M
        if self.u_host is not None:
            M = M + self.u_host.to_scipy()
        return M.tocsr()


def sstruct_matvec(A: SStructMatrix, x, alpha=1.0, beta=0.0, y=None):
    """y = alpha*(S + U) x + beta*y (sstruct_matvec.c dispatch); alpha
    and beta act on every part."""
    grid = A.grid
    out = []
    for p in range(grid.nparts):
        row = []
        for vi in range(grid.nvars(p)):
            acc = None
            for vj in range(grid.nvars(p)):
                sm = A.smats.get((p, vi, vj))
                if sm is None:
                    continue
                t = struct_matvec(sm, x[p][vj])
                acc = t if acc is None else acc + t
            if acc is None:
                acc = torch.zeros_like(x[p][vi])
            row.append(acc)
        out.append(row)
    if A.umat is not None:
        u_parts = unpack_vector(spmv(A.umat, pack_vector(x)), grid)
        for p in range(grid.nparts):
            for v in range(grid.nvars(p)):
                out[p][v] = out[p][v] + u_parts[p][v]
    res = tuple(tuple(r) for r in out)
    if alpha != 1.0:
        res = tuple(tuple(alpha * a for a in r) for r in res)
    if y is not None and beta != 0.0:
        res = tuple(tuple(a + beta * b for a, b in zip(r, yr))
                    for r, yr in zip(res, y))
    return res
