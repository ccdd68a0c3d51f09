"""The ELL SpMV (`hypre_tpu_torch/ops/ell_kernel.py`,
`csrc/ell_spmv.cu`), every form."""

from __future__ import annotations

from . import operator_bytes, vector_bytes

ENTRY = ("hypre_tpu_torch.ops.spmv", "ell_spmv_cuda")
KERNEL_NAMES = ("ell_spmv",)


def launch(call, cache) -> dict:
    """The table's nonzeros, x (its columns' entries), y (its rows'),
    the form's vectors."""
    data, x = call["data"], call["x"]
    n = data.shape[1]
    total = operator_bytes(cache.nnz(data), data)
    total += vector_bytes(x, call.get("f"), call.get("u"), call.get("d"))
    total += n * x.element_size()
    return {"bytes": total}
