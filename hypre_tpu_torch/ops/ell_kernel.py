"""The slot-major ELL SpMV as a hand-written CUDA kernel with fused
epilogues, and its plain torch version (the system's use of the TPU
gather probes K2/K3, scripts/exp_mosaic_gather.py: the gather of
x[cols], fused here with the multiply, the slot reduction and the
form's elementwise work, ops/forms.py).

`ell_spmv_cuda` launches `csrc/ell_spmv.cu`, built with nvcc for sm_90a
into a shared library with a plain C interface at first use (into
`hypre_tpu_torch/_build/`, rebuilt when the source is newer) and bound
with ctypes.  It takes (data, vectors) as (f64, f64), (f32, f32) or
(bf16, f32), int32 cols and row_len, and raises on anything else.
Each launch, whatever the form, adds one to `ell_spmv_cuda.launches`.

`ell_spmv_reference` is the JAX package's ELL SpMV in torch
(hypre_tpu/ops/spmv.py:24-30, transposed layout): gather x[cols], widen
the data to x's dtype, multiply, sum over the slot axis; then the
form's epilogue.  It runs on any device; the CPU tests use it, and
chip_smoke.py holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda
from .forms import FORMS, check_operands, epilogue

_DTYPES = {
    (torch.float64, torch.float64): "f64_f64",
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
}

# (data, cols, row_len, x, f, u, d, w, y, n, width, lanes, stream),
# every entry point alike
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_double, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_void_p])

# slot lanes a row: at most this many slots a lane, and lanes added while
# rows x lanes stay under this many threads (three 512-thread blocks on
# each of 132 SMs); both picked with lane_sweep.py on the 96^3 operators
_SLOTS_PER_LANE = 16
_FILL_THREADS = 132 * 3 * 512


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("ell_spmv", {f"ell_spmv_{form}_{dt}": _ARGTYPES
                                  for form in FORMS
                                  for dt in _DTYPES.values()})


def slot_lanes(width: int, n: int) -> int:
    """S, the threads that share one row (1, 2, 4, 8 or 16): enough that
    a lane walks at most 16 slots, more while the rows alone would
    leave SMs idle and a lane keeps at least one slot.  Large operators
    run best with few lanes (less reduction), small ones with many
    (fewer dependent loads in a row)."""
    s = 1
    while s < 16 and s * _SLOTS_PER_LANE < width:
        s *= 2
    while s < 16 and 2 * s <= width and 32 * s * -(-n // 32) < _FILL_THREADS:
        s *= 2
    return s


def ell_spmv_cuda(data: torch.Tensor, cols: torch.Tensor,
                  row_len: torch.Tensor, x: torch.Tensor,
                  form: str = "plain", *, f=None, u=None, d=None,
                  w: float = 1.0, lanes: int | None = None) -> torch.Tensor:
    """The form (ops/forms.py) of y = A x on the card, one launch.

    data and cols [width, n], row_len int32 [n] (row i's entries are
    slots 0..row_len[i]-1), x [num_cols] and the form's vectors [n] are
    contiguous CUDA tensors on one device; every cols entry lies in
    [0, num_cols).  jacobi needs a square operator (its u is x).
    `lanes` sets S (1, 2, 4, 8 or 16) instead of slot_lanes's pick."""
    if data.dim() != 2 or x.dim() != 1 or cols.shape != data.shape:
        raise ValueError("data and cols must be [width, n], x [num_cols]")
    width, n = data.shape
    if form == "jacobi" and x.shape[0] != n:
        raise ValueError(
            f"jacobi needs a square operator: {n} rows, x has {x.shape[0]}")
    check_operands("ell_spmv_cuda", form, x, n, f, u, d)
    if lanes is None:
        lanes = slot_lanes(width, n)
    elif lanes not in (1, 2, 4, 8, 16):
        raise ValueError(f"lanes must be 1, 2, 4, 8 or 16, got {lanes}")
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_cuda needs CUDA tensors, got {x.device}")
    if (data.device != x.device or cols.device != x.device
            or row_len.device != x.device):
        raise ValueError(
            f"device mismatch: data {data.device}, cols {cols.device}, "
            f"row_len {row_len.device}, x {x.device}")
    dt = _DTYPES.get((data.dtype, x.dtype))
    if dt is None:
        raise TypeError(
            f"ell_spmv_cuda: unsupported (data, x) dtypes {(data.dtype, x.dtype)}")
    if cols.dtype != torch.int32 or row_len.dtype != torch.int32:
        raise TypeError(
            f"cols and row_len must be int32, got {cols.dtype}, {row_len.dtype}")
    if row_len.shape != (n,):
        raise ValueError(f"row_len has shape {tuple(row_len.shape)}, not ({n},)")
    if not (data.is_contiguous() and cols.is_contiguous()
            and row_len.is_contiguous() and x.is_contiguous()):
        raise ValueError("ell_spmv_cuda needs contiguous tensors")
    lib, _ = load()
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"ell_spmv_{form}_{dt}")(
            data.data_ptr(), cols.data_ptr(), row_len.data_ptr(),
            x.data_ptr(), ptr(f), ptr(u), ptr(d), float(w), y.data_ptr(),
            n, width, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: CUDA error {rc}")
    ell_spmv_cuda.launches += 1
    return y


ell_spmv_cuda.launches = 0


def ell_spmv_reference(data: torch.Tensor, cols: torch.Tensor,
                       x: torch.Tensor, form: str = "plain", *, f=None,
                       u=None, d=None, w: float = 1.0) -> torch.Tensor:
    """Plain torch ELL SpMV, then the form's epilogue.  Narrower matrix
    data (bf16) is widened to x's dtype before the multiply, as jnp's
    type promotion does; padding slots add 0 * x[0]."""
    g = torch.index_select(x, 0, cols.reshape(-1)).view(cols.shape)
    y = torch.sum(data.to(x.dtype) * g, dim=0)
    return epilogue(form, y, x, f=f, u=u, d=d, w=w)
