"""ELL SpMV (port of hypre_tpu/ops/spmv.py::ell_spmv).

Reference analog: seq_mv/csr_matvec.c (hypre_CSRMatrixMatvec).  The
slot-major ELL layout turns SpMV into one gather and one reduction over
the slot axis.  The JAX package computes it outside any Pallas kernel
(its gather probes K2/K3 tested a Pallas form); the port runs it as one
hand-written CUDA kernel.

`ell_spmv` dispatches on the device of x alone: a CUDA tensor launches
the kernel (ops/ell_kernel.py) or raises; a CPU tensor takes its plain
torch version.  Either computes one of the epilogue forms of
ops/forms.py in the same call.
"""

from __future__ import annotations

import torch

from .csr import ELLMatrix
from .ell_kernel import ell_spmv_cuda, ell_spmv_reference

__all__ = ["ell_spmv", "ell_spmv_reference"]


def ell_spmv(A: ELLMatrix, x: torch.Tensor, form: str = "plain",
             **operands) -> torch.Tensor:
    """The form of y = A @ x (ops/forms.py: operands f, u, d, w), y of
    A.num_rows entries for x of A.num_cols."""
    if x.shape != (A.num_cols,):
        raise ValueError(
            f"ell_spmv: x has shape {tuple(x.shape)}, the operator "
            f"{A.num_rows}x{A.num_cols}")
    if x.device.type == "cuda":
        return ell_spmv_cuda(A.data, A.cols, A.row_len, x, form, **operands)
    if x.device.type == "cpu":
        return ell_spmv_reference(A.data, A.cols, x, form, **operands)
    raise ValueError(f"ell_spmv: no path for device {x.device}")
