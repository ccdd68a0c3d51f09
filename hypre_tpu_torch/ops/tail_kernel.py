"""The COO tail of a lattice operator as a hand-written CUDA kernel, and
its plain torch version (counterpart of hypre_tpu/ops/dia.py::tail_apply,
the system's use of the flat gather K2 (c) on the lattice path).

    y[rows_u[s]] += sum of vals[e] * x[cols[e]] over e in [seg_ptr[s], seg_ptr[s+1])

in place on y, for sorted distinct rows `rows_u` [nseg], the segment
pointers `seg_ptr` [nseg + 1] and the T entries (`cols`, `vals`); all
indices int32.  (vals, x and y) are (f64, f64), (f32, f32) or
(bf16, f32), as K1 takes them.

`coo_tail_cuda` launches `csrc/coo_tail.cu` (nvcc, sm_90a, ctypes, built
at first use into `hypre_tpu_torch/_build/`), one thread an output row,
each segment summed in stored order; every launch adds one to
`coo_tail_cuda.launches`.  A CPU tensor is refused.

`coo_tail_reference` is the plain version: `index_select`, multiply, an
ordered segment sum (`torch.segment_reduce`), `index_add_` on the
distinct rows.  It runs on any device; the CPU tests use it, and
chip_smoke.py holds the kernel against it on the card.  Why not this on
the card: it is four launches where the levels that carry tails are
bound by launches, and a segment sum by `index_add_` would use atomics,
whose order changes from run to run.

`coo_tail` dispatches on the device of x alone.  The solver's tails ride
in K1's launch (ops/dia_kernel.py, `tail=`), the same sum in the same
order; this kernel is the form for a tail with no K1 launch beside it
(`ops/dia.py::tail_apply`, and `spmv_tail_after`, the composition the
fused path is held against).
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda

_DTYPES = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
}
# (vals, cols, seg_ptr, rows_u, x, y, nseg, stream)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("coo_tail", {f"coo_tail_{dt}": _ARGTYPES
                                  for dt in _DTYPES.values()})


def _check(vals, cols, seg_ptr, rows_u, x, y) -> None:
    """Shapes and index types, on any device."""
    for name, t in (("cols", cols), ("seg_ptr", seg_ptr), ("rows_u", rows_u)):
        if t.dtype != torch.int32:
            raise TypeError(f"coo_tail: {name} must be int32, got {t.dtype}")
    if vals.dim() != 1 or cols.shape != vals.shape:
        raise ValueError(
            f"coo_tail: vals {tuple(vals.shape)} and cols "
            f"{tuple(cols.shape)} must be one [T]")
    if rows_u.dim() != 1 or seg_ptr.shape != (rows_u.shape[0] + 1,):
        raise ValueError(
            f"coo_tail: seg_ptr {tuple(seg_ptr.shape)} must be "
            f"[{rows_u.shape[0]} + 1] for rows_u {tuple(rows_u.shape)}")
    if x.dim() != 1 or y.dim() != 1 or y.dtype != x.dtype:
        raise ValueError("coo_tail: x and y must be 1-D of one dtype")


def coo_tail_cuda(vals: torch.Tensor, cols: torch.Tensor,
                  seg_ptr: torch.Tensor, rows_u: torch.Tensor,
                  x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Add the tail's product with x to y in place, on the card, one
    launch; returns y.  The indices are trusted: cols < len(x), rows_u <
    len(y), seg_ptr rising from 0 to T."""
    _check(vals, cols, seg_ptr, rows_u, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"coo_tail_cuda needs CUDA tensors, got {x.device}")
    tensors = (vals, cols, seg_ptr, rows_u, x, y)
    if any(t.device != x.device for t in tensors):
        raise ValueError(
            f"device mismatch: {[str(t.device) for t in tensors]}")
    dt = _DTYPES.get((vals.dtype, x.dtype))
    if dt is None:
        raise TypeError(
            f"coo_tail_cuda: unsupported (vals, x) dtypes {(vals.dtype, x.dtype)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("coo_tail_cuda needs contiguous tensors")
    lib, _ = load()
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"coo_tail_{dt}")(
            vals.data_ptr(), cols.data_ptr(), seg_ptr.data_ptr(),
            rows_u.data_ptr(), x.data_ptr(), y.data_ptr(), rows_u.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"coo_tail kernel launch failed: CUDA error {rc}")
    coo_tail_cuda.launches += 1
    return y


coo_tail_cuda.launches = 0


def coo_tail_reference(vals: torch.Tensor, cols: torch.Tensor,
                       seg_ptr: torch.Tensor, rows_u: torch.Tensor,
                       x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain torch version, in place on y; each segment is summed in
    stored order, starting from zero."""
    _check(vals, cols, seg_ptr, rows_u, x, y)
    contrib = vals.to(x.dtype) * torch.index_select(x, 0, cols)
    per_row = torch.segment_reduce(contrib, "sum", offsets=seg_ptr.long())
    return y.index_add_(0, rows_u, per_row)


def coo_tail(vals, cols, seg_ptr, rows_u, x, y) -> torch.Tensor:
    """y += tail @ x in place: the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cuda":
        return coo_tail_cuda(vals, cols, seg_ptr, rows_u, x, y)
    if x.device.type == "cpu":
        return coo_tail_reference(vals, cols, seg_ptr, rows_u, x, y)
    raise ValueError(f"coo_tail: no path for device {x.device}")
