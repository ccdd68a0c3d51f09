"""Structured stencil matrices and their matvec (port of
hypre_tpu/struct/matrix.py).

Reference: struct_mv/struct_matrix.{c,h} (per-stencil-entry data arrays)
and struct_matvec.c:92 (stencil-unrolled matvec).

A StructMatrix is {offset tuple -> coefficient array of grid shape}: the
variable entries stacked in `data` [ns, *shape] on the device, the
constant-coefficient ones (struct_matrix.h constant_coefficient) kept as
Python floats.  Out-of-grid neighbour values are zero (the
ghost-initialized-to-zero semantics of struct vectors); periodic axes
wrap.

`struct_matvec` sums the stencil in the JAX package's order (the
variable offsets sorted, then the constant ones) into one accumulator:
each offset adds its product, in place, into the part of the grid that
offset reaches (`addcmul_`; `add_` with the constant as its factor), so
no shifted copy of x is built.  A matrix whose taps that leave the box
are zero in `data` (`boxed`, done once where a solver freezes a level)
and that has no periodic axis takes flat runs instead: each variable
offset is one flat offset of the raveled grid, and its coefficients
multiply a contiguous run of x, so each term is two 1-D views (the
zeroed taps add 0, as the JAX package's zero-filled shift does).  A
periodic axis rolls x first; constant offsets take the grid slices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.errors import arg_error
from .grid import StructGrid

_NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _np_dtype(dtype):
    if dtype is None:
        return None
    return _NP_DTYPE.get(dtype, dtype)


def _wrapped(x: torch.Tensor, offset, periodic) -> torch.Tensor:
    """x rolled by -offset along the periodic axes (x itself if none)."""
    rolls = [(-o, d) for d, (o, p) in enumerate(zip(offset, periodic))
             if p and o]
    if not rolls:
        return x
    return torch.roll(x, [s for s, _ in rolls], [d for _, d in rolls])


def _reach(offset, shape, periodic):
    """(dst, src): the points i whose neighbour i + offset lies in the
    grid (along the periodic axes every point), and those neighbours."""
    dst, src = [], []
    for o, n, p in zip(offset, shape, periodic):
        if p or o == 0:
            dst.append(slice(None))
            src.append(slice(None))
        elif o > 0:
            dst.append(slice(0, max(n - o, 0)))
            src.append(slice(o, n))
        else:
            dst.append(slice(-o, n))
            src.append(slice(0, max(n + o, 0)))
    return tuple(dst), tuple(src)


def shift(x: torch.Tensor, offset, periodic=None) -> torch.Tensor:
    """out[i] = x[i + offset], zero-filled (or wrapped) outside."""
    periodic = periodic or (0,) * x.dim()
    xs = _wrapped(x, offset, periodic)
    dst, src = _reach(offset, x.shape, periodic)
    out = torch.zeros_like(x)
    out[dst] = xs[src]
    return out


@dataclasses.dataclass(frozen=True)
class StructMatrix:
    """offsets: static tuple of index-offset tuples; data: [ns, *shape].

    Constant-coefficient entries (HYPRE_StructMatrixSetConstantEntries)
    are Python floats (const_offsets / const_values): their matvec term
    reads only x.
    """

    data: torch.Tensor
    offsets: tuple
    periodic: tuple = None
    const_offsets: tuple = ()
    const_values: tuple = ()
    _shape: tuple = None
    # the taps that leave the box are zero in `data` (`boxed`)
    in_box: bool = False

    @classmethod
    def from_dict(cls, entries: dict, grid: StructGrid | None = None,
                  dtype=None, *, device="cuda") -> "StructMatrix":
        """Scalar (Python float / 0-d) entries become constant-coefficient
        storage; array entries stay variable."""
        var = {o: _host(v) for o, v in entries.items() if np.ndim(_host(v)) > 0}
        const = {o: float(_host(v)) for o, v in entries.items()
                 if np.ndim(_host(v)) == 0}
        offsets = tuple(sorted(var.keys()))
        arrs = [np.asarray(var[o], dtype=_np_dtype(dtype)) for o in offsets]
        if arrs:
            shape = arrs[0].shape
        elif grid is not None:
            shape = tuple(grid.shape)
        else:
            raise arg_error("all-constant StructMatrix needs a grid")
        co = tuple(sorted(const.keys()))
        data = torch.from_numpy(
            np.stack(arrs) if arrs
            else np.zeros((0, *shape), dtype=_np_dtype(dtype) or np.float64))
        return cls(
            data=data.to(device),
            offsets=offsets,
            periodic=grid.periodic if grid else (0,) * len(shape),
            const_offsets=co,
            const_values=tuple(const[o] for o in co),
            _shape=tuple(shape),
        )

    @property
    def shape(self):
        return self._shape if self._shape is not None else tuple(self.data.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def grid(self) -> StructGrid:
        return StructGrid(tuple(self.shape), self.periodic)

    @property
    def all_offsets(self):
        return tuple(sorted(set(self.offsets) | set(self.const_offsets)))

    def boxed(self) -> "StructMatrix":
        """The same operator with the taps that leave the box (along the
        non-periodic axes) zeroed in `data`, marked `in_box` so that
        `struct_matvec` runs it on flat runs.  `data` is copied only if
        such a tap is nonzero, and is not to be changed afterwards."""
        if self.in_box:
            return self
        periodic = self.periodic or (0,) * len(self.shape)
        data = self.data
        for k, off in enumerate(self.offsets):
            for d, (o, n, p) in enumerate(zip(off, self.shape, periodic)):
                if p or o == 0:
                    continue
                out = (k,) + (slice(None),) * d + (
                    slice(max(n - o, 0), n) if o > 0 else slice(0, min(-o, n)),)
                if bool(data[out].any()):
                    if data is self.data:
                        data = data.clone()
                    data[out] = 0
        return dataclasses.replace(self, data=data, in_box=True)

    def to(self, device) -> "StructMatrix":
        """The same matrix with its data on `device`."""
        return dataclasses.replace(self, data=self.data.to(device))

    def entry(self, offset) -> torch.Tensor:
        offset = tuple(offset)
        if offset in self.const_offsets:
            k = self.const_offsets.index(offset)
            return torch.full(self.shape, self.const_values[k],
                              dtype=self.dtype, device=self.device)
        return self.data[self.offsets.index(offset)]

    def diagonal(self) -> torch.Tensor:
        return self.entry((0,) * len(self.shape))

    def densify(self) -> "StructMatrix":
        """All-variable form (for setup paths that scan .data directly)."""
        if not self.const_offsets:
            return self
        data = _host(self.data)
        entries = {o: data[k] for k, o in enumerate(self.offsets)}
        for o, v in zip(self.const_offsets, self.const_values):
            entries[o] = np.full(self.shape, v)
        return StructMatrix.from_dict(entries, self.grid, device=self.device)

    # -- host conversions ------------------------------------------------
    def to_scipy(self) -> sp.csr_matrix:
        """Assemble the equivalent sparse matrix (out-of-grid couplings
        dropped = ghost-zero semantics).  Host-side, for setup/RAP."""
        shape = tuple(self.shape)
        n = int(np.prod(shape))
        grids = np.indices(shape)  # [ndim, *shape]
        row_id = np.ravel_multi_index(grids, shape).ravel()
        rows_l, cols_l, vals_l = [], [], []
        data = _host(self.data)
        all_entries = [(off, data[k]) for k, off in enumerate(self.offsets)]
        all_entries += [
            (off, np.full(shape, v))
            for off, v in zip(self.const_offsets, self.const_values)
        ]
        for off, ent in all_entries:
            tgt = [grids[d] + off[d] for d in range(len(shape))]
            ok = np.ones(shape, dtype=bool)
            for d in range(len(shape)):
                if self.periodic and self.periodic[d]:
                    tgt[d] = tgt[d] % shape[d]
                else:
                    ok &= (tgt[d] >= 0) & (tgt[d] < shape[d])
            col_id = np.ravel_multi_index(
                [np.clip(t, 0, s - 1) for t, s in zip(tgt, shape)], shape
            ).ravel()
            okf = ok.ravel()
            rows_l.append(row_id[okf])
            cols_l.append(col_id[okf])
            vals_l.append(ent.ravel()[okf])
        M = sp.coo_matrix(
            (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(n, n),
        ).tocsr()
        M.sum_duplicates()
        return M

    @classmethod
    def from_scipy(cls, M: sp.csr_matrix, shape: tuple, periodic=None, *,
                   device="cuda") -> "StructMatrix":
        """Inverse of to_scipy: recover the stencil-form representation.

        The offsets come out in the JAX package's order (its
        `np.unique(..., axis=0)` sorts the offset rows lexicographically),
        found here as the unique values of one integer code an offset,
        monotone in that order, which is much faster than a row unique."""
        Mc = M.tocoo()
        ri = np.array(np.unravel_index(Mc.row, shape))
        ci = np.array(np.unravel_index(Mc.col, shape))
        off = ci - ri  # [ndim, nnz]
        base = 2 * (int(np.abs(off).max(initial=0)) + 1) + 1
        code = np.zeros(off.shape[1], dtype=np.int64)
        for d in range(off.shape[0]):
            code = code * base + (off[d] + base // 2)
        codes, inv = np.unique(code, return_inverse=True)
        data = np.zeros((len(codes), int(np.prod(shape))))
        data[inv.ravel(), Mc.row] = Mc.data
        entries = {}
        for k, c in enumerate(codes):
            o = []
            for _ in range(off.shape[0]):
                o.append(int(c % base) - base // 2)
                c //= base
            entries[tuple(reversed(o))] = data[k].reshape(shape)
        g = StructGrid(tuple(shape), periodic)
        return cls.from_dict(entries, g, device=device)


def struct_matvec(A: StructMatrix, x: torch.Tensor, alpha=1.0, beta=0.0,
                  y=None) -> torch.Tensor:
    """y = alpha*A*x + beta*y (struct_matvec.c semantics).  A sharded
    vector (a tuple of grid blocks) takes its ShardedStructMatrix's
    product (parallel/par_struct.py)."""
    if not isinstance(x, torch.Tensor):
        return A.matvec(x, alpha, beta, y)
    periodic = A.periodic or (0,) * x.dim()
    acc = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if A.in_box and not any(periodic):
        n = x.numel()
        xf, af = x.reshape(-1), acc.view(-1)
        cf = A.data.reshape(len(A.offsets), n)
        for k, off in enumerate(A.offsets):
            f, stride = 0, 1
            for o, s in zip(reversed(off), reversed(x.shape)):
                f += o * stride
                stride *= s
            r0, x0, m = max(0, -f), max(0, f), n - abs(f)
            if m > 0:
                af.narrow(0, r0, m).addcmul_(cf[k].narrow(0, r0, m),
                                             xf.narrow(0, x0, m))
    else:
        for k, off in enumerate(A.offsets):
            dst, src = _reach(off, x.shape, periodic)
            acc[dst].addcmul_(A.data[k][dst], _wrapped(x, off, periodic)[src])
    for off, v in zip(A.const_offsets, A.const_values):
        dst, src = _reach(off, x.shape, periodic)
        acc[dst].add_(_wrapped(x, off, periodic)[src], alpha=v)
    if alpha != 1.0:
        acc = alpha * acc
    if y is not None and beta != 0.0:
        acc = acc + beta * y
    return acc
