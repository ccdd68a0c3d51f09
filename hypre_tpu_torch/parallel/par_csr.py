"""Distributed (sharded) CSR matrix with the diag / offd split (port of
hypre_tpu/parallel/par_csr.py; reference: parcsr_mv/par_csr_matrix.h:
27-94, diag = local columns, offd = external columns compressed through
col_map_offd, and par_csr_matvec.c:22-315).

Rows are equal block-partitioned over the mesh (`partition.py`).  On
the host each shard holds the JAX package's arrays, bitwise: a diag ELL
over local columns and an offd ELL over ghost slots ([S, per, width],
pad slots (0, 0) and (ghost_width, 0)), the per-row slot counts, the
col maps and the halo plan.  On its device each shard holds ONE
slot-major ELL operator over `[x_block | ghost]` (the input block's
length + ghost_width + 1 columns): a row's diag entries, then its offd
entries with the ghost slot shifted by the input block's length, packed
from slot 0 (`row_len` the two counts), so a product is the halo
exchange and one launch of the ELL kernel
(ops/ell_kernel.py; the plain version on the CPU).  Its sum runs over
the row's slots in order; the JAX package sums the diag and the offd
part apart and adds them, so the two agree to rounding, not bitwise.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..ops.csr import ELLMatrix, to_device, torch_dtype
from ..ops.spmv import ell_spmv
from ..utils.errors import arg_error
from .halo import HaloPlan, build_halo_plan, exchange
from .mesh import AXIS, default_mesh
from .par_vector import pad_blocks, unpad_blocks
from .partition import BlockPartition, block_partition


def _scipy(A) -> sp.csr_matrix:
    return A.to_scipy().tocsr() if hasattr(A, "to_scipy") else sp.csr_matrix(A)


class ParCSR:
    def __init__(self, A, mesh=None, axis: str = AXIS, max_offsets: int = 8,
                 col_part: BlockPartition | None = None, dtype=None):
        """Row-sharded sparse operator sliced from a host matrix A (a
        CSRMatrix or scipy).  For rectangular operators (P / R of a
        distributed hierarchy) pass `col_part`, the partition of the
        INPUT vector; the diag block then holds the columns of the
        shard's own input block.  Scalable setup paths use
        `from_row_blocks` with locally generated row blocks."""
        mesh = mesh or default_mesh()
        S = mesh.shape[axis]
        M = _scipy(A)
        n = M.shape[0]
        per = block_partition(n, S).rows_per_shard
        blocks = [M[min(s * per, n): min(s * per + per, n)] for s in range(S)]
        self._init_from_blocks(blocks, M.shape, mesh, axis, max_offsets,
                               col_part, dtype)

    @classmethod
    def from_row_blocks(cls, blocks, shape, mesh=None, axis: str = AXIS,
                        max_offsets: int = 8,
                        col_part: BlockPartition | None = None,
                        dtype=None) -> "ParCSR":
        """From per-shard row blocks (scipy CSR, local rows x GLOBAL
        columns) without ever forming the global matrix: the scalable
        setup entry point (each MPI rank assembles only its own rows).
        blocks[s] holds the rows of shard s's block partition."""
        self = cls.__new__(cls)
        self._init_from_blocks(blocks, shape, mesh or default_mesh(), axis,
                               max_offsets, col_part, dtype)
        return self

    def _init_from_blocks(self, blocks, shape, mesh, axis, max_offsets,
                          col_part, dtype=None):
        self.mesh = mesh
        self.axis = axis
        self.n, self.m = int(shape[0]), int(shape[1])
        S = mesh.shape[axis]
        if len(blocks) != S:
            raise arg_error(f"need {S} row blocks, got {len(blocks)}")
        self.part = block_partition(self.n, S)
        self.col_part = col_part or (
            self.part if self.m == self.n else block_partition(self.m, S))
        per = self.part.rows_per_shard
        cper = self.col_part.rows_per_shard

        # per-shard diag / offd split (the par_csr_matrix.h:40-44 layout)
        col_maps = []
        wd = wo = 1
        rows_struct = []
        self.host_blocks = []  # per-shard scipy CSR (local rows x global cols)
        for s in range(S):
            lo = min(s * per, self.n)
            hi = min(lo + per, self.n)
            clo = s * cper
            chi = min(clo + cper, self.m)
            blk = sp.csr_matrix(blocks[s])
            if dtype is not None:
                blk = blk.astype(dtype)
            if blk.shape[0] != hi - lo:
                raise arg_error(
                    f"shard {s}: expected {hi - lo} rows, got {blk.shape[0]}")
            self.host_blocks.append(blk)
            r = np.repeat(np.arange(hi - lo), np.diff(blk.indptr))
            c = blk.indices
            v = blk.data
            is_diag = (c >= clo) & (c < chi)
            cm = np.unique(c[~is_diag])
            col_maps.append(cm)
            rows_struct.append((r, c, v, is_diag, lo, hi, clo, cm))
            if len(r):
                wd = max(wd, int(np.bincount(r[is_diag], minlength=hi - lo)
                                 .max(initial=0)))
                if (~is_diag).any():
                    wo = max(wo, int(np.bincount(r[~is_diag],
                                                 minlength=hi - lo).max(initial=0)))

        self.col_maps = col_maps  # per-shard sorted ghost global col ids
        self.plan: HaloPlan = build_halo_plan(col_maps, self.col_part,
                                              max_offsets)
        gw = self.plan.ghost_width

        vdt = (np.dtype(dtype) if dtype is not None
               else np.result_type(*(b.data.dtype for b in blocks)))
        dc = np.zeros((S, per, wd), dtype=np.int32)
        dv = np.zeros((S, per, wd), dtype=vdt)
        oc = np.full((S, per, wo), gw, dtype=np.int32)  # pad -> zero sink slot
        ov = np.zeros((S, per, wo), dtype=vdt)
        # per-row valid-slot counts: tell ELL pad slots from real entries
        # with value 0
        self.diag_counts = np.zeros((S, per), dtype=np.int32)
        self.offd_counts = np.zeros((S, per), dtype=np.int32)
        for s, (r, c, v, is_diag, lo, hi, clo, cm) in enumerate(rows_struct):
            rd, cd, vd = r[is_diag], c[is_diag] - clo, v[is_diag]
            k = _slot_counter(rd)
            dc[s, rd, k] = cd
            dv[s, rd, k] = vd
            if len(rd):
                self.diag_counts[s] = np.bincount(rd, minlength=per)
            ro, co, vo = r[~is_diag], c[~is_diag], v[~is_diag]
            if len(ro):
                ghost_slot = np.searchsorted(cm, co)
                k = _slot_counter(ro)
                oc[s, ro, k] = ghost_slot
                ov[s, ro, k] = vo
                self.offd_counts[s] = np.bincount(ro, minlength=per)
        self.diag_cols, self.diag_data = dc, dv
        self.offd_cols, self.offd_data = oc, ov
        self._place()

    def _place(self) -> None:
        """Each shard's merged ELL operator on its device (module note)."""
        per = self.part.rows_per_shard
        cper = self.col_part.rows_per_shard
        gw = self.plan.ghost_width
        wd, wo = self.diag_cols.shape[2], self.offd_cols.shape[2]
        cols = np.concatenate([self.diag_cols, self.offd_cols + cper], axis=2)
        data = np.concatenate([self.diag_data, self.offd_data], axis=2)
        valid = np.concatenate(
            [np.arange(wd) < self.diag_counts[..., None],
             np.arange(wo) < self.offd_counts[..., None]], axis=2)
        # each row's real slots first, in order (a stable sort of ~valid)
        order = np.argsort(~valid, axis=2, kind="stable")
        cols = np.take_along_axis(cols, order, axis=2)
        data = np.take_along_axis(data, order, axis=2)
        row_len = self.diag_counts + self.offd_counts
        width = max(int(row_len.max(initial=0)), 1)
        keep = np.arange(width) < row_len[..., None]
        cols = np.where(keep, cols[..., :width], 0).astype(np.int32)
        data = np.where(keep, data[..., :width], 0).astype(data.dtype)
        tdt = torch_dtype(str(self.diag_data.dtype))
        self.ell = []
        for s, dev in enumerate(self.mesh.devices):
            self.ell.append(ELLMatrix(
                cols=torch.from_numpy(np.ascontiguousarray(cols[s].T)).to(dev),
                data=to_device(data[s].T, tdt, dev),
                num_rows=per, num_cols=cper + gw + 1,
                nnz=int(row_len[s].sum()),
                row_len=torch.from_numpy(row_len[s].copy()).to(dev)))
        self._diag_ell = None

    # ------------------------------------------------------------------
    def matvec(self, x) -> tuple:
        """x: the input's S blocks (col_part's rows_per_shard each) ->
        y's S blocks: the halo exchange, then one ELL launch a shard over
        [x_s | ghost_s]."""
        ghosts = exchange(self.plan, x)
        return tuple(ell_spmv(E, torch.cat([xs, g]))
                     for E, xs, g in zip(self.ell, x, ghosts))

    @property
    def matvec_fn(self):
        return self.matvec

    def kernel_launches(self) -> dict:
        """{kernel: launches} of one product on CUDA tensors (either
        `matvec` or `diag_matvec`): one ELL launch a shard."""
        return {"ell_spmv": self.mesh.size}

    def diag_matvec(self, x) -> tuple:
        """y = A_diagblock @ x (within-shard columns only, no exchange):
        the hybrid-GS split, A_offd x = matvec(x) - this."""
        if self._diag_ell is None:
            tdt = torch_dtype(str(self.diag_data.dtype))
            cper = self.col_part.rows_per_shard
            self._diag_ell = [ELLMatrix(
                cols=torch.from_numpy(
                    np.ascontiguousarray(self.diag_cols[s].T)).to(dev),
                data=to_device(self.diag_data[s].T, tdt, dev),
                num_rows=self.part.rows_per_shard, num_cols=cper,
                nnz=int(self.diag_counts[s].sum()),
                row_len=torch.from_numpy(self.diag_counts[s].copy()).to(dev))
                for s, dev in enumerate(self.mesh.devices)]
        return tuple(ell_spmv(E, xs) for E, xs in zip(self._diag_ell, x))

    @property
    def diag_matvec_fn(self):
        return self.diag_matvec

    # ------------------------------------------------------------------
    def pad_vec(self, v) -> tuple:
        """Host OUTPUT-space vector [n] -> its S padded blocks."""
        return pad_blocks(v, self.part.n_padded, self.mesh.devices)

    def pad_col_vec(self, v) -> tuple:
        """Host INPUT-space vector [m] -> its S padded blocks."""
        return pad_blocks(v, self.col_part.n_padded, self.mesh.devices)

    def unpad(self, y) -> np.ndarray:
        return unpad_blocks(y, self.n)


def _slot_counter(rows: np.ndarray) -> np.ndarray:
    """k-th occurrence index of each row id (rows sorted ascending)."""
    if len(rows) == 0:
        return rows
    first = np.empty(len(rows), dtype=bool)
    first[0] = True
    first[1:] = rows[1:] != rows[:-1]
    pos = np.arange(len(rows))
    start = np.maximum.accumulate(np.where(first, pos, 0))
    return pos - start
