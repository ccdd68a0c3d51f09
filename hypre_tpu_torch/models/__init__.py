from .laplacian import laplacian_7pt

__all__ = ["laplacian_7pt"]
