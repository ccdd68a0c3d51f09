"""Extended+i interpolation (interp_type "ext+i") of the port against
the JAX package's, on the same inputs.

P is bitwise equal (pattern, indptr, values) before and after
truncation at 10^3 and 16^3, and so is the whole host hierarchy (CF
split, P, coarse operators) at 10^3; at 48^3 (slow) the port's f64
solve on the plain forms takes the JAX package's iteration count,
EXT48_F64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg.interp import extended_i_interp as jax_ext_i
from hypre_tpu.solvers.amg.interp import truncate_interp as jax_truncate
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.coarsen import pmis_coarsen
from hypre_tpu_torch.solvers.amg.interp import (extended_i_interp,
                                                truncate_interp)
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

PLAIN = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)
# the JAX package's count on the CPU: 48^3, f64, the plain forms above,
# PCG two-norm, tol 1e-6, b = ones (chip_smoke.py pins the same)
EXT48_F64 = 12


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("nx", [10, 16])
def test_ext_i_interp_bitwise_matches_jax(nx):
    A = laplacian_7pt(nx, nx, nx).to_scipy().tocsr()
    A.sort_indices()
    S = strength_matrix(A)
    cf = pmis_coarsen(S)
    P = extended_i_interp(A, S, cf)
    ref = jax_ext_i(A, S, cf)
    assert P.shape == (nx**3, int((cf >= 0).sum()))
    assert same_csr(P, ref)
    # ext+i reaches distance-2 C points: wider rows than classical's
    assert np.diff(P.indptr).max() > 6
    assert same_csr(truncate_interp(P, 0.0, 4), jax_truncate(ref, 0.0, 4))
    assert np.diff(truncate_interp(P, 0.0, 4).indptr).max() == 4


@pytest.mark.parametrize("ngt", [0.0, 0.02])
def test_ext_i_hierarchy_bitwise_matches_jax(ngt):
    nx = 10
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx),
                    BoomerAMGOptions(nongalerkin_tol=ngt, **PLAIN), device="cpu")
    ref = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx),
                       JaxOptions(nongalerkin_tol=ngt, **PLAIN))
    assert len(amg._host_A) == len(ref._host_A) >= 3
    for k in range(len(ref._host_A)):
        assert np.array_equal(amg._cf[k], ref._cf[k]), f"CF, level {k}"
        assert same_csr(amg._host_A[k], ref._host_A[k]), f"A, level {k}"
    for k in range(len(ref._host_A) - 1):
        assert same_csr(amg._host_P[k], ref._host_P[k]), f"P, level {k}"
    # the unfiltered level-1 product is kept for the device RAP's plan
    assert same_csr(amg._host_A1_unf, ref._host_A1_unf)


@pytest.mark.slow
def test_ext_i_48_f64_takes_the_jax_count():
    nx = 48
    pcg_tol = dict(tol=1e-6, max_iter=200, two_norm=True)
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx),
                    BoomerAMGOptions(dtype="float64", **PLAIN), device="cpu")
    A0 = amg.levels[0].A
    res = pcg(lambda x: spmv(A0, x), torch.ones(nx**3, dtype=torch.float64),
              M=amg.precond, opts=PCGOptions(**pcg_tol))
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx),
                        JaxOptions(dtype="float64", **PLAIN))
    E = jamg.levels[0].A
    ref = jax_pcg(lambda x: jax_spmv(E, x), jnp.ones(nx**3),
                  M=jax.jit(jamg.cycle), opts=JaxPCGOptions(**pcg_tol))
    assert int(ref.num_iterations) == EXT48_F64
    assert res.converged and res.num_iterations == EXT48_F64
    n = EXT48_F64 + 1
    assert np.allclose(res.res_norms.numpy()[:n], np.asarray(ref.res_norms)[:n],
                       rtol=1e-9, atol=0)
