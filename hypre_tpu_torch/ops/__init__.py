from .csr import CSRMatrix, ELLMatrix
from .dia import (COOTail, DenseMatrix, DIAMatrix, DIAWithTail, GatherOp,
                  ParityInterpOp, ParityRestrictOp, ScatterOp, freeze_auto,
                  spmv, spmv_axpy, spmv_jacobi, spmv_resid)

__all__ = ["CSRMatrix", "ELLMatrix", "DenseMatrix", "DIAMatrix", "COOTail",
           "DIAWithTail", "GatherOp", "ScatterOp", "ParityRestrictOp",
           "ParityInterpOp", "freeze_auto", "spmv", "spmv_axpy",
           "spmv_jacobi", "spmv_resid"]
