"""K1, the DIA SpMV (`hypre_tpu_torch/ops/dia_kernel.py`,
`csrc/dia_spmv.cu`): every form and the COO tail a launch may carry."""

from __future__ import annotations

from . import operator_bytes, vector_bytes

ENTRY = ("hypre_tpu_torch.ops.dia", "dia_spmv_cuda")
KERNEL_NAMES = ("dia_spmv",)


def launch(call, cache) -> dict:
    """Needed bytes of one call, `call` its bound arguments: the DIA
    table's nonzeros and the tail's, x and y, the form's vectors, and
    of a tail's own source vector at most one value an entry."""
    data, x = call["data"], call["x"]
    nnz = cache.nnz(data)
    total = operator_bytes(nnz, data)
    tail = call.get("tail")
    if tail is not None:
        _, _, vals, tail_x = tail
        tnnz = cache.nnz(vals)
        total += operator_bytes(tnnz, vals)
        if tail_x is not None and tail_x is not x:
            total += min(tail_x.numel(), tnnz) * tail_x.element_size()
    # y: as many entries as x (K1 is square)
    total += vector_bytes(x, x, call.get("f"), call.get("u"), call.get("d"))
    return {"bytes": total}
