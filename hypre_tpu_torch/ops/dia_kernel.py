"""K1: the square DIA SpMV as a hand-written CUDA kernel with fused
epilogues, and its plain torch version (counterpart of
hypre_tpu/ops/pallas_dia.py; the forms are in ops/forms.py).

`dia_spmv_cuda` launches `csrc/dia_spmv.cu`, built with nvcc for sm_90a
into a shared library with a plain C interface at first use (into
`hypre_tpu_torch/_build/`, rebuilt when the source is newer) and bound
with ctypes.  It takes (data, vectors) as (f32, f32), (bf16, f32) or
(f64, f64) and raises on anything else.  The offsets come as a tuple
of ints: up to 8 go to the kernel by value, more through a cached
int64 copy on the card (`launch_plan`).  Each launch, whatever the form,
adds one to `dia_spmv_cuda.launches`.

`dia_spmv_reference` is the torch form of the JAX package's XLA shift
path (hypre_tpu/ops/dia.py:267-278): x is zero-padded, each diagonal
multiplies a shifted slice, and the products are summed in offset
order; then the form's epilogue.  It runs on any device; the CPU tests
use it, and chip_smoke.py holds the kernel against it on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..native import load_cuda
from .forms import FORMS, check_operands, epilogue

_DTYPES = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
}
# the kernel's offsets by value: up to this many, else a device array
MAX_BY_VALUE = 8

# (data, offsets on the card, offsets on the host, noff, x, f, u, d, w,
#  y, n, vec, wide, stream), every entry point alike
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p,
              ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
             + [ctypes.c_void_p] * 4 + [ctypes.c_double, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p])


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("dia_spmv", {f"dia_spmv_{form}_{dt}": _ARGTYPES
                                  for form in FORMS
                                  for dt in _DTYPES.values()})


@functools.lru_cache(maxsize=64)
def _host_offsets(offsets: tuple):
    return (ctypes.c_int64 * max(len(offsets), 1))(*offsets)


@functools.lru_cache(maxsize=64)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, offsets: tuple) -> tuple[bool, bool]:
    """(offsets by value, 64-bit index math) of a K1 launch: up to
    MAX_BY_VALUE offsets go by value, more through the device array;
    64-bit indices when a data index (below noff * n) or a row or x
    index (below n + the largest |offset| + 1024: the grid's last
    threads start up to 1024 rows past n) can reach 2^31, whatever the
    count."""
    reach = max(len(offsets) * n,
                n + max((abs(o) for o in offsets), default=0) + 1024)
    return len(offsets) <= MAX_BY_VALUE, reach >= 2**31


def rows_per_thread(data: torch.Tensor) -> int:
    """R, the rows one thread takes on the 16-byte path: 16 bytes of
    data (8 in bf16, 4 in f32, 2 in f64)."""
    return 16 // data.element_size()


def vector_path(n: int, data: torch.Tensor, *vectors) -> bool:
    """Whether the kernel takes R rows a thread with 16-byte loads: n a
    multiple of R and every pointer 16-byte aligned."""
    return n % rows_per_thread(data) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (data, *vectors) if t is not None)


def dia_spmv_cuda(data: torch.Tensor, offsets: tuple, x: torch.Tensor,
                  form: str = "plain", *, f=None, u=None, d=None,
                  w: float = 1.0) -> torch.Tensor:
    """The form (ops/forms.py) of y = A x, A[i, i + offsets[k]] =
    data[k, i], on the card (K1), one launch.

    data [noff, n], x [n] and the form's vectors [n] are contiguous
    CUDA tensors on one device; offsets is a tuple of noff ints."""
    if data.dim() != 2 or x.dim() != 1:
        raise ValueError("data must be [noff, n], x [n]")
    noff, n = data.shape
    if x.shape[0] != n:
        raise ValueError(
            f"non-square DIA operator: {n} rows, x has {x.shape[0]} entries")
    if len(offsets) != noff:
        raise ValueError(f"{len(offsets)} offsets for {noff} diagonals")
    check_operands("dia_spmv_cuda", form, x, n, f, u, d)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv_cuda needs CUDA tensors, got {x.device}")
    if data.device != x.device:
        raise ValueError(
            f"device mismatch: data {data.device}, x {x.device}")
    dt = _DTYPES.get((data.dtype, x.dtype))
    if dt is None:
        raise TypeError(
            f"dia_spmv_cuda: unsupported (data, x) dtypes {(data.dtype, x.dtype)}")
    if not (data.is_contiguous() and x.is_contiguous()):
        raise ValueError("dia_spmv_cuda needs contiguous tensors")
    lib, _ = load()
    y = torch.empty_like(x)
    by_value, wide = launch_plan(n, tuple(offsets))
    offs_dev = (None if by_value else
                _device_offsets(tuple(offsets), x.device).data_ptr())
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    vec = vector_path(n, data, x, f, u, d, y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"dia_spmv_{form}_{dt}")(
            data.data_ptr(), offs_dev, _host_offsets(tuple(offsets)), noff,
            x.data_ptr(), ptr(f), ptr(u), ptr(d), float(w), y.data_ptr(),
            n, int(vec), int(wide), stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {rc}")
    dia_spmv_cuda.launches += 1
    return y


dia_spmv_cuda.launches = 0


def dia_spmv_reference(data: torch.Tensor, offsets: tuple, x: torch.Tensor,
                       form: str = "plain", *, f=None, u=None, d=None,
                       w: float = 1.0) -> torch.Tensor:
    """Plain torch DIA SpMV, the same sum as K1 (taps outside [0, n)
    read the zero padding), then the form's epilogue."""
    n = x.shape[0]
    if not offsets:
        acc = torch.zeros_like(x)
    else:
        lo = max(0, -min(offsets))
        xp = F.pad(x, (lo, max(0, max(offsets))))
        acc = None
        for k, off in enumerate(offsets):
            t = data[k].to(x.dtype) * xp[lo + off: lo + off + n]
            acc = t if acc is None else acc + t
    return epilogue(form, acc, x, f=f, u=u, d=d, w=w)
