from .krylov import bicgstab, gmres, pcg

__all__ = ["bicgstab", "gmres", "pcg"]
