from .common import SolverResult
from .pcg import PCGOptions, pcg

__all__ = ["PCGOptions", "SolverResult", "pcg"]
