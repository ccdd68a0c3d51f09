"""The slot-major ELL SpMV as a hand-written CUDA kernel, and its plain
torch version (the system's use of the TPU gather probes K2/K3,
scripts/exp_mosaic_gather.py: the gather of x[cols], fused here with the
multiply and the slot reduction).

`ell_spmv_cuda` launches `csrc/ell_spmv.cu`, built with nvcc for sm_90a
into a shared library with a plain C interface at first use (into
`hypre_tpu_torch/_build/`, rebuilt when the source is newer) and bound
with ctypes.  It takes (data, x) as (f64, f64), (f32, f32) or
(bf16, f32), int32 cols, and raises on anything else.  Each launch adds
one to `ell_spmv_cuda.launches`.

`ell_spmv_reference` is the JAX package's ELL SpMV in torch
(hypre_tpu/ops/spmv.py:24-30, transposed layout): gather x[cols], widen
the data to x's dtype, multiply, sum over the slot axis.  It runs on any
device; the CPU tests use it, and chip_smoke.py holds the kernel against
it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda

_ENTRY = {
    (torch.float64, torch.float64): "ell_spmv_f64_f64",
    (torch.float32, torch.float32): "ell_spmv_f32_f32",
    (torch.bfloat16, torch.float32): "ell_spmv_bf16_f32",
}

# (data, cols, x, y, n, width, stream), every entry point alike
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p]


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("ell_spmv", {e: _ARGTYPES for e in _ENTRY.values()})


def ell_spmv_cuda(data: torch.Tensor, cols: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_s data[s, i] * x[cols[s, i]] on the card.

    data and cols [width, n] and x [num_cols] are contiguous CUDA
    tensors on one device; every cols entry lies in [0, num_cols)."""
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_cuda needs CUDA tensors, got {x.device}")
    if data.device != x.device or cols.device != x.device:
        raise ValueError(
            f"device mismatch: data {data.device}, cols {cols.device}, "
            f"x {x.device}")
    key = (data.dtype, x.dtype)
    if key not in _ENTRY:
        raise TypeError(f"ell_spmv_cuda: unsupported (data, x) dtypes {key}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if data.dim() != 2 or x.dim() != 1 or cols.shape != data.shape:
        raise ValueError("data and cols must be [width, n], x [num_cols]")
    if not (data.is_contiguous() and cols.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("ell_spmv_cuda needs contiguous tensors")
    width, n = data.shape
    lib, _ = load()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[key])(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
            n, width, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {rc}")
    ell_spmv_cuda.launches += 1
    return y


ell_spmv_cuda.launches = 0


def ell_spmv_reference(data: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain torch ELL SpMV.  Narrower matrix data (bf16) is widened to
    x's dtype before the multiply, as jnp's type promotion does."""
    g = torch.index_select(x, 0, cols.reshape(-1)).view(cols.shape)
    return torch.sum(data.to(x.dtype) * g, dim=0)
