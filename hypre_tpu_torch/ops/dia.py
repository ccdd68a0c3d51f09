"""DIA (diagonal) format, dense format and the polymorphic `spmv`
(port of the slice's part of hypre_tpu/ops/dia.py).

Matrices whose nonzeros live on few distinct diagonals (the stencil
fine level) are stored as row-aligned diagonals, data[k, i] =
A[i, i + offsets[k]], exactly [noff, n]; small coarse matrices are
dense; everything else is slot-major ELL.  `freeze_auto` picks per
matrix with the JAX package's thresholds, so both packages freeze a
hierarchy into the same formats.

`dia_spmv` dispatches on the device of x alone: a CUDA tensor launches
the hand-written kernel K1 (ops/dia_kernel.py) or raises; a CPU tensor
takes K1's plain torch version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
from .csr import CSRMatrix, ELLMatrix, to_device, torch_dtype
from .dia_kernel import dia_spmv_cuda, dia_spmv_reference
from .spmv import ell_spmv

# freeze_auto's thresholds, the JAX package's (picked there for the TPU;
# re-deriving them for the H100 is open work, see PERF.md)
DIA_MAX_OFFSETS = 48
DENSE_MAX_ROWS = 6144


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Square, data[k, i] = A[i, i + offsets[k]]; offsets sorted."""

    data: torch.Tensor  # [noff, n]
    offsets: tuple
    num_rows: int
    num_cols: int
    # the offsets as an int64 tensor beside `data`, for the kernel
    offsets_t: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.num_rows != self.num_cols:
            raise ValueError(
                f"DIAMatrix is square only, got {self.num_rows}x{self.num_cols}")
        if tuple(self.data.shape) != (len(self.offsets), self.num_rows):
            raise ValueError(
                f"DIA data {tuple(self.data.shape)} does not match "
                f"{len(self.offsets)} offsets x {self.num_rows} rows")
        object.__setattr__(self, "offsets_t", torch.tensor(
            self.offsets, dtype=torch.int64, device=self.data.device))


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    data: torch.Tensor  # [n, m]
    num_rows: int
    num_cols: int


def csr_to_dia(A: CSRMatrix, dtype, device) -> DIAMatrix:
    """Square CSR -> DIA on `device` (native one-pass conversion)."""
    n, m = A.shape
    if n != m:
        raise ValueError(f"csr_to_dia needs a square matrix, got {n}x{m}")
    dt = torch_dtype(dtype)
    uniq, data = native.dia_convert(A.to_scipy(), str(dt).split(".")[-1])
    if dt == torch.bfloat16:
        t = torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(data)
    return DIAMatrix(data=t.to(device), offsets=tuple(int(o) for o in uniq),
                     num_rows=n, num_cols=m)


def dia_spmv(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y_i = sum_k data[k,i] * x[i + off_k]: K1 on CUDA, plain on CPU."""
    if x.device.type == "cuda":
        return dia_spmv_cuda(A.data, A.offsets_t, x)
    if x.device.type == "cpu":
        return dia_spmv_reference(A.data, A.offsets, x)
    raise ValueError(f"dia_spmv: no path for device {x.device}")


def dense_spmv(A: DenseMatrix, x: torch.Tensor) -> torch.Tensor:
    # torch.matmul refuses mixed dtypes (jnp promotes): widen explicitly
    return A.data.to(x.dtype) @ x


def freeze_auto(A: CSRMatrix, dtype, device):
    """Pick the device format for this matrix: dense if small, DIA if
    square with few distinct diagonals, ELL otherwise."""
    n, m = A.shape
    if n <= DENSE_MAX_ROWS and m <= DENSE_MAX_ROWS:
        return DenseMatrix(
            data=to_device(A.to_scipy().toarray(), torch_dtype(dtype), device),
            num_rows=n,
            num_cols=m,
        )
    if n == m and A.nnz:
        if len(native.dia_offsets_only(A.to_scipy())) <= DIA_MAX_OFFSETS:
            return csr_to_dia(A, dtype, device)
    return A.to_ell(dtype, device)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """Polymorphic matvec over DIA / dense / ELL."""
    if isinstance(A, DIAMatrix):
        return dia_spmv(A, x)
    if isinstance(A, DenseMatrix):
        return dense_spmv(A, x)
    if isinstance(A, ELLMatrix):
        return ell_spmv(A, x)
    raise TypeError(f"spmv: unsupported operator {type(A).__name__}")
