"""The TPU gather probes K2/K3 (scripts/exp_mosaic_gather.py) as
hand-written CUDA kernels, and their plain torch versions.

    take_along_axis_cuda(x, idx, axis)  out[r, c] = x[r mod R, idx[r, c]] (axis 1)
                                        out[r, c] = x[idx[r, c], c mod C] (axis 0)
    flat_take_cuda(table, idx)          out = table[idx]

x is [R, C]; along axis 1 idx's rows are a multiple of R (K3 gathers
8 blocks of 512 rows from one resident [512, 512] x block), along
axis 0 idx's columns are a multiple of C.  With idx the shape of x this
is `np.take_along_axis`.  Values are f32, indices int32 in range.

`take_along_axis_cuda` and `flat_take_cuda` launch `csrc/gather.cu`
(nvcc, sm_90a, ctypes, built at first use into `hypre_tpu_torch/_build/`)
and count their launches; a CPU tensor is refused.  Their plain
versions (`torch.take_along_dim`, `torch.index_select`) run on any
device: the CPU tests hold them against numpy, and chip_smoke.py holds
the kernels against them on the card.  Nothing in the solver calls
these gathers: the ELL SpMV kernel is the gather the solver runs.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda

_ARGTYPES = {
    # (x, idx, out, x rows, x cols, idx rows, idx cols, axis, stream)
    "take_along_axis_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
    + [ctypes.c_int, ctypes.c_void_p],
    # (table, idx, out, count, stream)
    "flat_take_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p],
}


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("gather", _ARGTYPES)


def _check(name: str, src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {src.device}")
    if idx.device != src.device:
        raise ValueError(f"device mismatch: {src.device}, idx {idx.device}")
    if src.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"{name}: needs f32 values and int32 indices, got "
                        f"{src.dtype} and {idx.dtype}")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} needs contiguous tensors")


def _shapes(x: torch.Tensor, idx: torch.Tensor, axis: int):
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if x.dim() != 2 or idx.dim() != 2:
        raise ValueError("take_along_axis needs 2-D x and idx")
    (xr, xc), (ir, ic) = x.shape, idx.shape
    other_x, other_i = (xr, ir) if axis == 1 else (xc, ic)
    if other_x == 0 or other_i % other_x:
        raise ValueError(
            f"idx {tuple(idx.shape)} does not tile x {tuple(x.shape)} "
            f"across axis {1 - axis}")
    return xr, xc, ir, ic


def _launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def take_along_axis_cuda(x: torch.Tensor, idx: torch.Tensor,
                         axis: int) -> torch.Tensor:
    """take_along_axis on the card (K2 (a)/(b), K3)."""
    _check("take_along_axis_cuda", x, idx)
    xr, xc, ir, ic = _shapes(x, idx, axis)
    lib, _ = load()
    out = torch.empty(ir, ic, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch(lib.take_along_axis_f32(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), xr, xc, ir, ic,
            axis, torch.cuda.current_stream().cuda_stream), "take_along_axis")
    take_along_axis_cuda.launches += 1
    return out


take_along_axis_cuda.launches = 0


def flat_take_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] on the card (K2 (c)); table is 1-D, idx any shape."""
    _check("flat_take_cuda", table, idx)
    if table.dim() != 1:
        raise ValueError("flat_take needs a 1-D table")
    lib, _ = load()
    out = torch.empty(idx.shape, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        _launch(lib.flat_take_f32(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
            torch.cuda.current_stream().cuda_stream), "flat_take")
    flat_take_cuda.launches += 1
    return out


flat_take_cuda.launches = 0


def take_along_axis_reference(x: torch.Tensor, idx: torch.Tensor,
                              axis: int) -> torch.Tensor:
    """Plain torch take_along_axis with x tiled as the kernel reads it."""
    xr, xc, ir, ic = _shapes(x, idx, axis)
    idx = idx.long()  # take_along_dim takes int64 indices only
    if axis == 1:
        out = torch.take_along_dim(x.unsqueeze(0),
                                   idx.reshape(ir // xr, xr, ic), dim=2)
    else:
        out = torch.take_along_dim(x.unsqueeze(1),
                                   idx.reshape(ir, ic // xc, xc), dim=0)
    return out.reshape(ir, ic)


def flat_take_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch table[idx]."""
    return torch.index_select(table, 0, idx.reshape(-1)).view(idx.shape)

