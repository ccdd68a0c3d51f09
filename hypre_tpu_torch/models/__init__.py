from .laplacian import difconv_7pt, laplacian_7pt, laplacian_27pt

__all__ = ["difconv_7pt", "laplacian_7pt", "laplacian_27pt"]
