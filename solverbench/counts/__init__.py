"""The frozen counting the rooflines use: the bytes a launch needs and
the wavefronts a Gauss-Seidel sweep must take one after another.

Needed bytes do not depend on the storage format.  A launch that applies
an operator needs its nonzero values once, at the width they are stored
in, and each vector it reads or writes once: x, y and the vectors of the
fused form (f, u, d).  Slots of a DIA or ELL table that hold no nonzero
(padding, the zero fill of a short diagonal) and every index array are
not counted, so a change of format leaves the yardstick where it was.

Each kernel family that has a roofline sits in a module of its own here
(`k1.py`, `ell.py`, `gs.py`), which names the program's entry point
(`ENTRY`: module and attribute), the kernels the profiler shows for it
(`KERNEL_NAMES`) and `launch(args, kwargs)`, the needed bytes and
wavefronts of one call.  `families()` finds them by file, so a later
kernel brings its own file.
"""

from __future__ import annotations

import importlib
import pkgutil

import torch


def families() -> dict:
    """{family name: its module} for every counting module here."""
    out = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        if hasattr(mod, "ENTRY"):
            out[info.name] = mod
    return out


def nonzeros(values: torch.Tensor) -> int:
    """Nonzero entries of a value table (padding slots hold zeros)."""
    return int(torch.count_nonzero(values))


def vector_bytes(*vectors) -> int:
    """Bytes of the given vectors, each once; None entries count 0."""
    return sum(v.numel() * v.element_size() for v in vectors
               if v is not None)


def operator_bytes(nnz: int, values: torch.Tensor) -> int:
    """The nonzero values at their stored width."""
    return nnz * values.element_size()


class OperatorCache:
    """Nonzero counts by value table, counted once: the same operator is
    applied many times a solve."""

    def __init__(self):
        self._seen = {}

    def nnz(self, values: torch.Tensor) -> int:
        key = (values.data_ptr(), tuple(values.shape), values.dtype)
        return self.memo(key, lambda: nonzeros(values))

    def memo(self, key, make):
        """make()'s value, made once for `key`."""
        if key not in self._seen:
            self._seen[key] = make()
        return self._seen[key]
