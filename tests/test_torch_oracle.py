"""Pinned iteration counts of the port's slice on the CPU (slow tier).

BoomerAMG-PCG on the nx^3 7-point Poisson problem, b = ones, two-norm
test, tol 1e-6, PMIS + classical interpolation (P_max_elmts 4) +
l1-Jacobi, collapse_coarse_n=0.  f64 counts are hypre's own oracle
counts (BASELINE.md); the f32-vector / bf16-matrix / nongalerkin 0.02
counts are the JAX package's on the CPU.  This file imports neither jax
nor hypre_tpu, so it also runs where jax is absent:
    python -m pytest --noconftest -m slow tests/test_torch_oracle.py
"""

import pytest
import torch

from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

ORACLE_F64 = {48: 20, 96: 25}
JAX_F32_BF16 = {48: 18, 96: 21}
SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)


def solve(nx, **kw):
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**SLICE, **kw),
                    device="cpu")
    b = torch.ones(nx**3, dtype=getattr(torch, kw["dtype"]))
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), b, M=amg.precond,
               opts=PCGOptions(tol=1e-6, max_iter=80, two_norm=True))


@pytest.mark.slow
@pytest.mark.parametrize("nx", [48, 96])
def test_oracle_iterations_f64(nx):
    res = solve(nx, dtype="float64")
    assert res.converged and res.num_iterations == ORACLE_F64[nx]


@pytest.mark.slow
@pytest.mark.parametrize("nx", [48, 96])
def test_production_iterations_f32_bf16(nx):
    res = solve(nx, dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02)
    assert res.converged and res.num_iterations == JAX_F32_BF16[nx]
