from .csr import CSRMatrix, ELLMatrix
from .dia import DenseMatrix, DIAMatrix, freeze_auto, spmv

__all__ = ["CSRMatrix", "ELLMatrix", "DenseMatrix", "DIAMatrix",
           "freeze_auto", "spmv"]
