"""The flagship single-device step (counterpart of the JAX package's
`__graft_entry__.entry`).

    step, (b,) = entry(device="cuda")
    x, rel_residual_norm = step(b)

BoomerAMG-preconditioned PCG on the 24^3 7-point Poisson problem with
the JAX package's flagship options: PMIS, extended+i interpolation
(P_max_elmts 4), l1-Jacobi (relax 18) down and up, the lattice forms on
the 24^3 lattice with the embedding's level-1 values from the device
RAP (the defaults embed_level1 and device_rap), float32 vectors and
bfloat16 matrices.  `step` runs one block of at most 10 PCG iterations
to tol 1e-8 from a zero guess.  The setup runs when `entry` is called;
the hierarchy lives on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import laplacian_7pt
from .ops import spmv
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .solvers.krylov import PCGOptions, pcg

NX = 24


def entry_options() -> BoomerAMGOptions:
    """The options `__graft_entry__.entry` passes, on the NX^3 lattice."""
    return BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18, lattice_shape=(NX, NX, NX),
        dtype="float32", mat_dtype="bfloat16")


def entry(device="cuda"):
    """(step, (b,)): set up the hierarchy on `device` and return the
    solve step with its example right-hand side b = A @ ones (float32,
    on `device`).  `step.amg` is the BoomerAMG hierarchy."""
    n = NX**3
    A = laplacian_7pt(NX, NX, NX)
    amg = BoomerAMG(A, entry_options(), device=device)
    E = amg.levels[0].A

    def step(b):
        res = pcg(lambda x: spmv(E, x), b, M=amg.precond,
                  opts=PCGOptions(tol=1e-8, max_iter=10))
        return res.x, res.rel_residual_norm

    step.amg = amg  # the hierarchy, for inspection
    b = torch.from_numpy((A.to_scipy() @ np.ones(n)).astype(np.float32))
    return step, (b.to(device),)
