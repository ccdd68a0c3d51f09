"""IJ assembly interface (port of hypre_tpu/models/ij.py; reference:
IJ_mv/, SURVEY §2.4).

The linear-algebra-view assembly API: create an empty matrix/vector by
global extents, SetValues/AddToValues in any order, Assemble, GetObject.
Mirrors hypre semantics (IJMatrix_parcsr.c): SetValues overwrites any
earlier contribution to an entry; AddToValues accumulates; a Set after
Adds discards them; Adds after a Set accumulate on top of it.

`IJMatrix` is the host accumulator (the aux_parcsr_matrix.c analog),
numpy sorts instead of per-row dynamic arrays, as in the JAX package.
`IJMatrixDevice` resolves the same streams on a torch device
(`ij_assemble_device`).  `IJMatrixSharded` assembles a row-sharded
ParCSR (parallel/par_csr.py) from per-shard call queues.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.csr import CSRMatrix


class IJMatrix:
    def __init__(self, nrows: int, ncols: int):
        self.shape = (int(nrows), int(ncols))
        self._rows: list[np.ndarray] = []
        self._cols: list[np.ndarray] = []
        self._vals: list[np.ndarray] = []
        self._isset: list[np.ndarray] = []
        self._assembled: CSRMatrix | None = None

    def _push(self, rows, cols, values, is_set: bool):
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        values = np.atleast_1d(np.asarray(values, dtype=np.float64))
        rows, cols, values = np.broadcast_arrays(rows, cols, values)
        self._rows.append(rows.ravel())
        self._cols.append(cols.ravel())
        self._vals.append(values.ravel())
        self._isset.append(np.full(rows.size, is_set))
        self._assembled = None

    def set_values(self, rows, cols, values):
        self._push(rows, cols, values, True)

    def add_to_values(self, rows, cols, values):
        self._push(rows, cols, values, False)

    def set_row(self, row, cols, values):
        self._push(np.full(len(cols), row), cols, values, True)

    def _streams(self):
        """(rows, cols, values, is_set) of every call, in arrival order."""
        return (np.concatenate(self._rows), np.concatenate(self._cols),
                np.concatenate(self._vals), np.concatenate(self._isset))

    def assemble(self) -> CSRMatrix:
        if self._assembled is not None:
            return self._assembled
        if not self._rows:
            self._assembled = CSRMatrix.from_coo([], [], [], self.shape)
            return self._assembled
        rows, cols, vals, isset = self._streams()
        seq = np.arange(rows.size)

        # sort by (row, col, seq); per (row,col) group, keep the suffix
        # after the last Set (inclusive of that Set's value).
        order = np.lexsort((seq, cols, rows))
        r, c, v, s = rows[order], cols[order], vals[order], isset[order]
        new_grp = np.empty(r.size, dtype=bool)
        new_grp[0] = True
        new_grp[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        grp_id = np.cumsum(new_grp) - 1
        # FINAL last-Set position per group (or -1): entries strictly
        # before it are discarded — a Set overwrites earlier Sets AND
        # earlier Adds (IJMatrix_parcsr.c semantics; a running cummax
        # here would wrongly keep contributions between two Sets)
        pos = np.arange(r.size)
        set_pos = np.where(s, pos, -1)
        starts = np.flatnonzero(new_grp)
        grp_last = np.maximum.reduceat(set_pos, starts)
        keep = pos >= grp_last[grp_id]  # all kept when group has no Set
        self._assembled = CSRMatrix.from_coo(
            r[keep], c[keep], v[keep], self.shape
        )
        return self._assembled

    # hypre naming
    def get_object(self) -> CSRMatrix:
        return self.assemble()


class IJVector:
    def __init__(self, n: int):
        self.n = int(n)
        self._data = np.zeros(self.n)
        self._touched = np.zeros(self.n, dtype=bool)

    def set_values(self, idx, values):
        idx = np.asarray(idx, dtype=np.int64)
        self._data[idx] = values
        self._touched[idx] = True

    def add_to_values(self, idx, values):
        np.add.at(self._data, np.asarray(idx, dtype=np.int64), values)
        self._touched[idx] = True

    def assemble(self) -> np.ndarray:
        return self._data

    get_object = assemble


def _stable_order(key: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """`order` stably re-sorted by key[order] (one pass of a lexsort)."""
    _, idx = torch.sort(key[order], stable=True)
    return order[idx]


def ij_assemble_device(rows, cols, values, is_set, shape, *, device="cuda"):
    """Device-side IJ assembly (reference: IJ_mv/IJMatrix_parcsr_device.c
    — device-pointer SetValues/AddToValues resolved with sort + segment
    reductions instead of host per-row accumulators).

    rows/cols/values/is_set: staged entry streams (tensors or host
    arrays), in arrival order; they are moved to `device`.  Semantics
    match the host accumulator: the LAST Set wins and only Adds arriving
    after it accumulate on top; with no Set, all Adds sum.  Entries are
    keyed by the (row, col) PAIR, as in the JAX package: two stable
    sorts (by col, then by row) over arrival order take the place of its
    lexsort, so there is no row*ncols+col product to overflow.  The
    segment maximum is a scatter_reduce "amax", the segment sum an
    index_add_ (on CUDA it adds with atomics, in no fixed order).

    Returns (urows, ucols, uvals) tensors on `device` of the assembled
    unique entries, sorted by (row, col)."""
    dev = torch.device(device)
    rows = torch.as_tensor(rows, dtype=torch.int64).to(dev)
    cols = torch.as_tensor(cols, dtype=torch.int64).to(dev)
    values = torch.as_tensor(values, dtype=torch.float64).to(dev)
    is_set = torch.as_tensor(is_set, dtype=torch.bool).to(dev)
    m = int(rows.shape[0])
    del shape  # dimensions only bound the inputs; keys are pairs
    seq = torch.arange(m, dtype=torch.int64, device=dev)
    if m == 0:
        return rows, cols, values

    order = _stable_order(rows, _stable_order(cols, seq))
    row_s, col_s = rows[order], cols[order]
    seq_s, val_s, set_s = seq[order], values[order], is_set[order]

    # segment ids over sorted unique (row, col) pairs
    new_seg = torch.ones(m, dtype=torch.bool, device=dev)
    new_seg[1:] = (row_s[1:] != row_s[:-1]) | (col_s[1:] != col_s[:-1])
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1
    nseg = int(seg[-1]) + 1

    # last Set per segment (-1 if none)
    set_seq = torch.where(set_s, seq_s, -1)
    last_set = torch.full((nseg,), -1, dtype=torch.int64, device=dev)
    last_set.scatter_reduce_(0, seg, set_seq, "amax")
    keep = torch.where(set_s, seq_s == last_set[seg], seq_s > last_set[seg])
    uvals = torch.zeros(nseg, dtype=torch.float64, device=dev)
    uvals.index_add_(0, seg, torch.where(keep, val_s, 0.0))
    first_idx = torch.nonzero(new_seg).flatten()
    return row_s[first_idx], col_s[first_idx], uvals


class IJMatrixDevice(IJMatrix):
    """IJMatrix whose Assemble runs on `device` (ij_assemble_device)."""

    def __init__(self, nrows: int, ncols: int, *, device="cuda"):
        super().__init__(nrows, ncols)
        self.device = torch.device(device)

    def assemble(self) -> CSRMatrix:
        if self._assembled is not None:
            return self._assembled
        if not self._rows:
            self._assembled = CSRMatrix.from_coo([], [], [], self.shape)
            return self._assembled
        ur, uc, uv = ij_assemble_device(*self._streams(), self.shape,
                                        device=self.device)
        self._assembled = CSRMatrix.from_coo(
            ur.cpu().numpy(), uc.cpu().numpy(), uv.cpu().numpy(), self.shape
        )
        return self._assembled


class IJMatrixSharded:
    """Distributed IJ assembly (IJMatrix_parcsr.c:2774
    hypre_IJMatrixAssembleParCSR): each shard queues Set / AddTo calls,
    rows it does not own included; Assemble ships the queues to the
    owning shards (the MPI exchange), resolves set-wins-then-add per
    owner and builds the row-sharded ParCSR from the per-shard blocks
    (no global matrix image).

    The reference leaves the cross-rank order of Sets to MPI arrival;
    here contributions resolve in a fixed total order, the JAX
    package's: by owner, then source shard, then call order, so
    re-assembly repeats bitwise."""

    def __init__(self, nrows: int, ncols: int, mesh=None, axis=None):
        from ..parallel.mesh import AXIS, default_mesh
        from ..parallel.partition import block_partition

        self.shape = (int(nrows), int(ncols))
        self.mesh = mesh or default_mesh()
        self.axis = axis or AXIS
        self.S = self.mesh.shape[self.axis]
        self.part = block_partition(nrows, self.S)
        self._bufs = [IJMatrix(nrows, ncols) for _ in range(self.S)]

    def set_values(self, shard: int, rows, cols, values):
        self._bufs[shard].set_values(rows, cols, values)

    def add_to_values(self, shard: int, rows, cols, values):
        self._bufs[shard].add_to_values(rows, cols, values)

    def assemble(self):
        from ..parallel.par_csr import ParCSR

        nrows, ncols = self.shape
        per = self.part.rows_per_shard
        # the exchange: owner o receives every source shard's entries
        # for its rows, in (source shard, call order) order
        owners_bufs = [IJMatrix(nrows, ncols) for _ in range(self.S)]
        for s in range(self.S):
            b = self._bufs[s]
            for rows, cols, vals, isset in zip(b._rows, b._cols, b._vals,
                                               b._isset):
                own = self.part.owner(rows)
                for o in np.unique(own):
                    m = own == o
                    owners_bufs[int(o)]._push(rows[m], cols[m], vals[m],
                                              bool(isset[0]))
        blocks = []
        for o in range(self.S):
            M = owners_bufs[o].assemble().to_scipy().tocsr()
            lo = min(o * per, nrows)
            hi = min(lo + per, nrows)
            blocks.append(M[lo:hi])
        return ParCSR.from_row_blocks(blocks, self.shape, mesh=self.mesh,
                                      axis=self.axis)
