"""K1: the square DIA SpMV as a hand-written CUDA kernel, and its plain
torch version (counterpart of hypre_tpu/ops/pallas_dia.py).

`dia_spmv_cuda` launches `csrc/dia_spmv.cu`, built with nvcc for sm_90a
into a shared library with a plain C interface at first use (into
`hypre_tpu_torch/_build/`, rebuilt when the source is newer) and bound
with ctypes.  It takes (data, x) as (f32, f32), (bf16, f32) or
(f64, f64) and raises on anything else.  Each launch adds one to
`dia_spmv_cuda.launches`.

`dia_spmv_reference` is the torch form of the JAX package's XLA shift
path (hypre_tpu/ops/dia.py:267-278): x is zero-padded, each diagonal
multiplies a shifted slice, and the products are summed in offset
order.  It runs on any device; the CPU tests use it, and chip_smoke.py
holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch
import torch.nn.functional as F

from ..native import BUILD_DIR, build_shared

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "dia_spmv.cu")
_SO = os.path.join(BUILD_DIR, "libdia_spmv.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_ENTRY = {
    (torch.float32, torch.float32): "dia_spmv_f32_f32",
    (torch.bfloat16, torch.float32): "dia_spmv_bf16_f32",
    (torch.float64, torch.float64): "dia_spmv_f64_f64",
}

_lib = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when it was current)."""
    global _lib
    log = ""
    if _lib is None:
        log = build_shared([_nvcc(), *NVCC_FLAGS], _SRC, _SO)
        lib = ctypes.CDLL(_SO)
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib, log


def dia_spmv_cuda(data: torch.Tensor, offsets: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k data[k, i] * x[i + offsets[k]] on the card (K1).

    data [noff, n], offsets int64 [noff] and x [n] are contiguous CUDA
    tensors on one device."""
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv_cuda needs CUDA tensors, got {x.device}")
    if data.device != x.device or offsets.device != x.device:
        raise ValueError(
            f"device mismatch: data {data.device}, offsets {offsets.device}, "
            f"x {x.device}")
    key = (data.dtype, x.dtype)
    if key not in _ENTRY:
        raise TypeError(f"dia_spmv_cuda: unsupported (data, x) dtypes {key}")
    if offsets.dtype != torch.int64:
        raise TypeError(f"offsets must be int64, got {offsets.dtype}")
    if data.dim() != 2 or x.dim() != 1 or offsets.dim() != 1:
        raise ValueError("data must be [noff, n], offsets [noff], x [n]")
    noff, n = data.shape
    if x.shape[0] != n:
        raise ValueError(
            f"non-square DIA operator: {n} rows, x has {x.shape[0]} entries")
    if offsets.shape[0] != noff:
        raise ValueError(f"{offsets.shape[0]} offsets for {noff} diagonals")
    if not (data.is_contiguous() and x.is_contiguous()
            and offsets.is_contiguous()):
        raise ValueError("dia_spmv_cuda needs contiguous tensors")
    lib, _ = load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, _ENTRY[key])(
            data.data_ptr(), offsets.data_ptr(), x.data_ptr(), y.data_ptr(),
            n, noff, stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {rc}")
    dia_spmv_cuda.launches += 1
    return y


dia_spmv_cuda.launches = 0


def dia_spmv_reference(data: torch.Tensor, offsets: tuple,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain torch DIA SpMV, the same sum as K1 (taps outside [0, n)
    read the zero padding)."""
    n = x.shape[0]
    if not offsets:
        return torch.zeros_like(x)
    lo = max(0, -min(offsets))
    xp = F.pad(x, (lo, max(0, max(offsets))))
    acc = None
    for k, off in enumerate(offsets):
        t = data[k].to(x.dtype) * xp[lo + off: lo + off + n]
        acc = t if acc is None else acc + t
    return acc
