from .lobpcg import LOBPCGOptions, LOBPCGResult, lobpcg

__all__ = ["LOBPCGOptions", "LOBPCGResult", "lobpcg"]
