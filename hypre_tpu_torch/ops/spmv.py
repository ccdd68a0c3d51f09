"""ELL SpMV (port of hypre_tpu/ops/spmv.py::ell_spmv).

Reference analog: seq_mv/csr_matvec.c (hypre_CSRMatrixMatvec).  The
slot-major ELL layout turns SpMV into one gather and one reduction over
the slot axis.  The JAX package computes it outside any Pallas kernel,
and so does the port: plain torch on every device.
"""

from __future__ import annotations

import torch

from .csr import ELLMatrix


def ell_spmv(A: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  Narrower matrix data (bf16) is widened to x's dtype
    before the multiply, as jnp's type promotion does."""
    g = torch.index_select(x, 0, A.cols.reshape(-1)).view(A.cols.shape)
    return torch.sum(A.data.to(x.dtype) * g, dim=0)
