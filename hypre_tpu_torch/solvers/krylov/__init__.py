from .bicgstab import BiCGSTABOptions, bicgstab
from .cgnr import CGNROptions, cgnr
from .cogmres import COGMRESOptions, cogmres
from .common import SolverResult
from .flexgmres import FlexGMRESOptions, flexgmres
from .gmres import GMRESOptions, gmres
from .lgmres import LGMRESOptions, lgmres
from .pcg import PCGOptions, pcg

__all__ = ["BiCGSTABOptions", "CGNROptions", "COGMRESOptions",
           "FlexGMRESOptions", "GMRESOptions", "LGMRESOptions", "PCGOptions",
           "SolverResult", "bicgstab", "cgnr", "cogmres", "flexgmres", "gmres",
           "lgmres", "pcg"]
