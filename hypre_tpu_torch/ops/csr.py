"""Sparse matrix containers: host CSR + device ELL (port of
hypre_tpu/ops/csr.py).

Reference analog: seq_mv/csr_matrix.{c,h} (hypre_CSRMatrix).  The
shape-dynamic CSR lives on the host (numpy), where all setup runs;
before the solve phase a matrix is frozen into a static-shape padded
ELL layout on an explicit torch device.

ELL layout: slot-major `[width, n]` (the JAX package's `transposed`
form), so neighbouring rows read neighbouring addresses for each slot.
Padding entries point at column 0 with value 0, so no masking is
needed; `row_len` gives each row's count of leading real slots, so the
ELL kernel skips the padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def torch_dtype(name) -> torch.dtype:
    """torch dtype from a name such as "float64" or "bfloat16"."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host float array -> tensor of `dtype` on `device`.  bfloat16 is
    rounded on the host as float64 -> float32 -> bfloat16 (round to
    nearest even), the rounding the native DIA fill uses, whatever the
    device."""
    if dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
        return t.to(torch.bfloat16).to(device)
    np_dt = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np_dt)).to(device)


class CSRMatrix:
    """Host-side CSR (numpy), the setup-phase workhorse."""

    __slots__ = ("indptr", "indices", "data", "shape")

    def __init__(self, indptr, indices, data, shape):
        # keep scipy's int32 index currency; anything else becomes int64
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        if indptr.dtype != np.int32:
            indptr = indptr.astype(np.int64, copy=False)
        if indices.dtype != np.int32:
            indices = indices.astype(np.int64, copy=False)
        self.indptr = indptr
        self.indices = indices
        self.data = np.asarray(data)
        self.shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_scipy(cls, m) -> "CSRMatrix":
        m = m.tocsr()
        return cls(m.indptr, m.indices, m.data, m.shape)

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape
        )

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_ell(self, dtype, device) -> "ELLMatrix":
        """Freeze into slot-major ELL on `device`; row i's entries keep
        their CSR order in slots 0..row_nnz(i)-1."""
        n, m = self.shape
        rn = self.row_nnz()
        width = max(int(rn.max(initial=0)), 1)
        cols = np.zeros((width, n), dtype=np.int32)
        vals = np.zeros((width, n), dtype=np.float64)
        if self.nnz:
            r = np.repeat(np.arange(n), rn)
            k = np.arange(self.nnz) - np.repeat(self.indptr[:-1], rn)
            cols[k, r] = self.indices
            vals[k, r] = self.data
        return ELLMatrix(
            cols=torch.from_numpy(cols).to(device),
            data=to_device(vals, torch_dtype(dtype), device),
            num_rows=n,
            num_cols=m,
            nnz=self.nnz,
            row_len=torch.from_numpy(rn.astype(np.int32)).to(device),
        )


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Device-side padded ELL, slot-major: cols/data are [width, n].
    Both are contiguous and cols is int32, as the ELL kernel takes them.
    row_len (int32 [n], each in [0, width]) bounds each row's real
    slots; when it is not given it is derived on the tensors' device as
    the last slot whose cols or data is nonzero, plus one (the padding
    is (0, 0))."""

    cols: torch.Tensor  # int32 [width, n]
    data: torch.Tensor  # real  [width, n]
    num_rows: int
    num_cols: int
    nnz: int
    row_len: torch.Tensor = None  # int32 [n]

    def __post_init__(self):
        if self.cols.dtype != torch.int32:
            raise TypeError(f"ELL cols must be int32, got {self.cols.dtype}")
        if (self.data.dim() != 2 or self.cols.shape != self.data.shape
                or self.data.shape[1] != self.num_rows):
            raise ValueError(
                f"ELL cols {tuple(self.cols.shape)} and data "
                f"{tuple(self.data.shape)} must be [width, {self.num_rows}]")
        if not (self.cols.is_contiguous() and self.data.is_contiguous()):
            raise ValueError("ELL cols and data must be contiguous")
        width = self.cols.shape[0]
        if self.row_len is None:
            real = (self.cols != 0) | (self.data != 0)
            slot = torch.arange(1, width + 1, dtype=torch.int32,
                                device=self.cols.device).unsqueeze(1)
            object.__setattr__(self, "row_len", torch.amax(
                torch.where(real, slot, 0), dim=0).to(torch.int32))
            return
        if (self.row_len.dtype != torch.int32
                or self.row_len.shape != (self.num_rows,)
                or self.row_len.device != self.cols.device):
            raise ValueError(
                f"ELL row_len must be int32 [{self.num_rows}] on "
                f"{self.cols.device}")
        # the ELL kernel reads slots 0..row_len[i]-1 without a check
        if self.num_rows and not bool(
                ((self.row_len >= 0) & (self.row_len <= width)).all()):
            raise ValueError(f"ELL row_len entries must lie in [0, {width}]")
