"""K1: the square DIA SpMV as a hand-written CUDA kernel with fused
epilogues, and its plain torch version (counterpart of
hypre_tpu/ops/pallas_dia.py; the forms are in ops/forms.py).

`dia_spmv_cuda` launches `csrc/dia_spmv.cu`, built with nvcc for sm_90a
into a shared library with a plain C interface at first use (into
`hypre_tpu_torch/_build/`, rebuilt when the source is newer) and bound
with ctypes.  It takes (data, vectors) as (f32, f32), (bf16, f32) or
(f64, f64) and raises on anything else.  The offsets come as a tuple
of ints: up to 8 go to the kernel by value, more through a cached
int64 copy on the card (`launch_plan`).  Many offsets on few rows (the
relocated lattice operators) are split over `offset_lanes` lanes a row.
Each launch, whatever the form, adds one to `dia_spmv_cuda.launches`.  `out=` names the tensor the
kernel writes (a row of a [B, n] buffer, for the parity operators of
ops/dia.py); without it the wrapper allocates the result.  `tail=(ptr,
cols, vals, tail_x)` adds a COO tail to the sum before the form's
epilogue, in the same launch (ops/dia.py::COOTail: `ptr` the int32 row
pointer over the n output rows, `cols` int32, `vals` in data's dtype,
`tail_x` the vector it gathers from, x when None); a launch that carries
one also adds one to `dia_spmv_cuda.tail_launches`.

`dia_spmv_reference` is the torch form of the JAX package's XLA shift
path (hypre_tpu/ops/dia.py:267-278): x is zero-padded, each diagonal
multiplies a shifted slice, and the products are summed in offset
order; then the tail's rows, each summed from zero in stored order and
added to the rows it has entries on; then the form's epilogue.  It runs
on any device; the CPU tests
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
#  y, n, vec, wide, lanes, tail ptr, tail cols, tail vals, tail x,
#  stream), every entry point alike
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p,
              ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
             + [ctypes.c_void_p] * 4 + [ctypes.c_double, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int]
             + [ctypes.c_void_p] * 5)
# the offset-lane kernel: at most this many lanes a row, each with at
# least MIN_TAPS_A_LANE taps, until the card has FILL_THREADS threads
MAX_LANES = 32
MIN_TAPS_A_LANE = 2
FILL_THREADS = 132 * 2048


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("dia_spmv", {f"dia_spmv_{form}_{dt}": _ARGTYPES
                                  for form in FORMS
                                  for dt in _DTYPES.values()})


# one entry per distinct offset tuple: a lattice hierarchy holds some
# dozens of operators (8 parity matrices a transfer), each launched every
# cycle, and an evicted device copy would be re-uploaded at each launch
_OFFSET_CACHE = 1024


@functools.lru_cache(maxsize=_OFFSET_CACHE)
def _host_offsets(offsets: tuple):
    return (ctypes.c_int64 * max(len(offsets), 1))(*offsets)


@functools.lru_cache(maxsize=_OFFSET_CACHE)
def _device_offsets(offsets: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(offsets, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=_OFFSET_CACHE)
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


def offset_lanes(n: int, noff: int) -> int:
    """S, the lanes that share one row's offsets: 1 (one thread takes R
    rows and every offset in turn) while the offsets go by value or the
    rows alone fill the card; else doubled until n * S threads fill it,
    each lane keeping at least MIN_TAPS_A_LANE taps."""
    if noff <= MAX_BY_VALUE:
        return 1
    lanes = 1
    while (lanes < MAX_LANES and n * lanes < FILL_THREADS
           and noff >= 2 * lanes * MIN_TAPS_A_LANE):
        lanes *= 2
    return lanes


def rows_per_thread(data: torch.Tensor) -> int:
    """R, the rows one thread takes on the 16-byte path: 16 bytes of
    data (8 in bf16, 4 in f32, 2 in f64)."""
    return 16 // data.element_size()


def vector_path(n: int, data: torch.Tensor, *vectors) -> bool:
    """Whether the kernel takes R rows a thread with 16-byte loads: n a
    multiple of R and every pointer 16-byte aligned."""
    return n % rows_per_thread(data) == 0 and all(
        t.data_ptr() % 16 == 0 for t in (data, *vectors) if t is not None)


def _tail_operands(tail, data: torch.Tensor, x: torch.Tensor, n: int):
    """(ptr, cols, vals, tail_x) of a K1 tail, tail_x defaulting to x;
    raises unless ptr is int32 [n + 1], cols int32 and vals of data's
    dtype are one [T], tail_x is 1-D of x's dtype, all on x's device.
    The indices are trusted: ptr rising from 0 to T, cols < len(tail_x)."""
    ptr, cols, vals, tx = tail
    tx = x if tx is None else tx
    if ptr.dtype != torch.int32 or cols.dtype != torch.int32:
        raise TypeError(f"dia_spmv tail: ptr and cols must be int32, got "
                        f"{ptr.dtype} and {cols.dtype}")
    if ptr.shape != (n + 1,):
        raise ValueError(f"dia_spmv tail: ptr {tuple(ptr.shape)} must be "
                         f"[{n} + 1], one entry a row and one past the last")
    if cols.dim() != 1 or vals.shape != cols.shape:
        raise ValueError(f"dia_spmv tail: vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} must be one [T]")
    if vals.dtype != data.dtype or tx.dtype != x.dtype or tx.dim() != 1:
        raise TypeError(f"dia_spmv tail: vals {vals.dtype} and tail_x "
                        f"{tx.dtype} must be data's {data.dtype} and a 1-D "
                        f"vector of x's {x.dtype}")
    if any(t.device != x.device for t in (ptr, cols, vals, tx)):
        raise ValueError("dia_spmv tail: device mismatch with x "
                         f"{x.device}")
    return ptr, cols, vals, tx


def dia_spmv_cuda(data: torch.Tensor, offsets: tuple, x: torch.Tensor,
                  form: str = "plain", *, f=None, u=None, d=None,
                  w: float = 1.0, out=None, lanes=None,
                  tail=None) -> torch.Tensor:
    """The form (ops/forms.py) of y = A x, A[i, i + offsets[k]] =
    data[k, i], on the card (K1), one launch.

    data [noff, n], x [n] and the form's vectors [n] are contiguous
    CUDA tensors on one device; offsets is a tuple of noff ints (none
    is legal).  `out`, when given, is a contiguous [n] tensor like x
    that aliases no operand; the kernel writes the result there.
    `lanes` overrides `offset_lanes` (a power of two up to MAX_LANES;
    for the sweep of lane_sweep.py).  `tail` (see the module note) adds
    a COO tail to A x before the epilogue; its tensors are contiguous."""
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
    if out is not None and not (
            out.shape == x.shape and out.dtype == x.dtype
            and out.device == x.device and out.is_contiguous()):
        raise ValueError("dia_spmv_cuda: out must be a contiguous tensor of "
                         "x's shape, dtype and device")
    if tail is not None:
        tail = _tail_operands(tail, data, x, n)
        if not all(t.is_contiguous() for t in tail):
            raise ValueError("dia_spmv_cuda needs a contiguous tail")
    lib, _ = load()
    y = torch.empty_like(x) if out is None else out
    by_value, wide = launch_plan(n, tuple(offsets))
    if lanes is None:
        lanes = offset_lanes(n, noff)
    elif lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"dia_spmv_cuda: lanes must be a power of two up to "
                         f"{MAX_LANES}, got {lanes}")
    offs_dev = (None if by_value and lanes == 1 else
                _device_offsets(tuple(offsets), x.device).data_ptr())
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    # a tail takes the one-row-a-thread instances (csrc/dia_spmv.cu)
    vec = tail is None and vector_path(n, data, x, f, u, d, y)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"dia_spmv_{form}_{dt}")(
            data.data_ptr(), offs_dev, _host_offsets(tuple(offsets)), noff,
            x.data_ptr(), ptr(f), ptr(u), ptr(d), float(w), y.data_ptr(),
            n, int(vec), int(wide), lanes,
            *(ptr(t) for t in (tail or (None,) * 4)), stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: CUDA error {rc}")
    dia_spmv_cuda.launches += 1
    if tail is not None:
        dia_spmv_cuda.tail_launches += 1
    return y


dia_spmv_cuda.launches = 0
dia_spmv_cuda.tail_launches = 0


def dia_spmv_reference(data: torch.Tensor, offsets: tuple, x: torch.Tensor,
                       form: str = "plain", *, f=None, u=None, d=None,
                       w: float = 1.0, out=None, tail=None) -> torch.Tensor:
    """Plain torch DIA SpMV, the same sum as K1 (taps outside [0, n)
    read the zero padding), plus the tail when one is given (each row's
    segment summed from zero in stored order, `segment_reduce`, and
    added where the segment is not empty), then the form's epilogue;
    copied into `out` when that is given."""
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
    if tail is not None:
        ptr, cols, vals, tx = _tail_operands(tail, data, x, n)
        contrib = vals.to(x.dtype) * torch.index_select(tx, 0, cols)
        per_row = torch.segment_reduce(contrib, "sum", offsets=ptr.long())
        acc = torch.where(torch.diff(ptr) > 0, acc + per_row, acc)
    y = epilogue(form, acc, x, f=f, u=u, d=d, w=w)
    return y if out is None else out.copy_(y)
