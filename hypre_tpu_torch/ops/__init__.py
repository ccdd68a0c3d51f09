from .csr import CSRMatrix, ELLMatrix
from .dia import (DenseMatrix, DIAMatrix, freeze_auto, spmv, spmv_axpy,
                  spmv_jacobi, spmv_resid)

__all__ = ["CSRMatrix", "ELLMatrix", "DenseMatrix", "DIAMatrix",
           "freeze_auto", "spmv", "spmv_axpy", "spmv_jacobi", "spmv_resid"]
