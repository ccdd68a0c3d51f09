"""A dense operator on relocated cells as one hand-written CUDA kernel
(gather, gemv and scatter in one launch), and its plain torch version:
the collapsed coarse solve of the lattice path,
ScatterOp(GatherOp(DenseMatrix)) with one position map (ops/dia.py::on_cells).

    y[c] = sum_j M[row_of_cell[c], j] * x[pos[j]]    (0 where row_of_cell[c] == -1)

M is square [k, k]; pos int32 [k] holds the cells of its rows and
columns, row_of_cell int32 [ncells] the inverse (-1 on a cell no row
sits on); (M, x) are (f64, f64), (f32, f32) or (bf16, f32), as K1 takes
them.

`cell_dense_cuda` launches `csrc/cell_dense.cu` (nvcc, sm_90a, ctypes,
built at first use into `hypre_tpu_torch/_build/`): each block stages
x[pos] in shared memory, one warp a row of M, written to its cell, the
empty cells zeroed in the same launch; every launch adds one to
`cell_dense_cuda.launches`.  A CPU tensor is refused.

`cell_dense_reference` is the plain version: `flat_take_reference`,
`torch.matmul`, then a scatter into zeros, the ops the port ran before
(bitwise those on the CPU).  It runs on any device; the CPU path and the
CPU tests use it, and chip_smoke.py holds the kernel against it on the
card.  `cell_dense` dispatches on the device of x alone.
"""

from __future__ import annotations

import ctypes

import torch

from ..native import load_cuda
from .gather_kernel import flat_take_reference

_DTYPES = {
    (torch.float32, torch.float32): "f32_f32",
    (torch.bfloat16, torch.float32): "bf16_f32",
    (torch.float64, torch.float64): "f64_f64",
}
# (M, pos, row_of_cell, x, y, cols, ncells, stream)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
# the shared memory a block of an H100 can have: x[pos] must fit
MAX_SHARED_BYTES = 232_448


def load():
    """Build (if stale) and load the kernel library.  Returns (library,
    compiler output of this call's build, empty when nothing was built)."""
    return load_cuda("cell_dense", {f"cell_dense_{dt}": _ARGTYPES
                                    for dt in _DTYPES.values()})


def _check(M, pos, row_of_cell, x) -> None:
    """Shapes and index types, on any device."""
    if pos.dtype != torch.int32 or row_of_cell.dtype != torch.int32:
        raise TypeError(f"cell_dense: pos and row_of_cell must be int32, "
                        f"got {pos.dtype} and {row_of_cell.dtype}")
    if M.dim() != 2 or M.shape[0] != M.shape[1] or pos.shape != (M.shape[1],):
        raise ValueError(f"cell_dense: M {tuple(M.shape)} must be square "
                         f"[k, k] with pos {tuple(pos.shape)} one [k]")
    if row_of_cell.dim() != 1 or x.dim() != 1:
        raise ValueError("cell_dense: row_of_cell and x must be 1-D")


def cell_dense_cuda(M: torch.Tensor, pos: torch.Tensor,
                    row_of_cell: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y [ncells] on the card, one launch.  The indices are trusted: pos
    distinct and < len(x), row_of_cell its inverse (row_of_cell[pos[r]]
    = r, -1 elsewhere)."""
    _check(M, pos, row_of_cell, x)
    if x.device.type != "cuda":
        raise ValueError(f"cell_dense_cuda needs CUDA tensors, got {x.device}")
    tensors = (M, pos, row_of_cell, x)
    if any(t.device != x.device for t in tensors):
        raise ValueError(
            f"device mismatch: {[str(t.device) for t in tensors]}")
    dt = _DTYPES.get((M.dtype, x.dtype))
    if dt is None:
        raise TypeError(
            f"cell_dense_cuda: unsupported (M, x) dtypes {(M.dtype, x.dtype)}")
    cols = M.shape[1]
    if cols * x.element_size() > MAX_SHARED_BYTES:
        raise ValueError(f"cell_dense_cuda: x[pos] ({cols} values) does not "
                         f"fit a block's {MAX_SHARED_BYTES} bytes of shared "
                         f"memory")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cell_dense_cuda needs contiguous tensors")
    lib, _ = load()
    y = torch.empty(row_of_cell.shape[0], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"cell_dense_{dt}")(
            M.data_ptr(), pos.data_ptr(), row_of_cell.data_ptr(), x.data_ptr(),
            y.data_ptr(), cols, y.shape[0],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cell_dense kernel launch failed: CUDA error {rc}")
    cell_dense_cuda.launches += 1
    return y


cell_dense_cuda.launches = 0


def cell_dense_reference(M: torch.Tensor, pos: torch.Tensor,
                         row_of_cell: torch.Tensor,
                         x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the gather, the dense product, and the
    product's rows written into zeros at their cells."""
    _check(M, pos, row_of_cell, x)
    z = M.to(x.dtype) @ flat_take_reference(x, pos)
    y = torch.zeros(row_of_cell.shape[0], dtype=x.dtype, device=x.device)
    live = row_of_cell >= 0
    y[live] = z[row_of_cell[live].long()]
    return y


def cell_dense(M, pos, row_of_cell, x) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return cell_dense_cuda(M, pos, row_of_cell, x)
    if x.device.type == "cpu":
        return cell_dense_reference(M, pos, row_of_cell, x)
    raise ValueError(f"cell_dense: no path for device {x.device}")
