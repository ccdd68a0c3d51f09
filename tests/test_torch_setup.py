"""Host AMG setup of the port against the JAX package: the CF split,
P and the coarse operators are bitwise equal on every level."""

import numpy as np
import pytest

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.coarsen import pmis_coarsen
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.utils.lcg import HypreLCG, lcg_fill
from torch_threads import one_thread  # noqa: F401

SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("nx", [10, 24])
@pytest.mark.parametrize("ngt", [0.0, 0.02])
def test_setup_bitwise_matches_jax(nx, ngt):
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx),
                    BoomerAMGOptions(nongalerkin_tol=ngt, **SLICE),
                    device="cpu")
    ref = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx),
                       JaxOptions(nongalerkin_tol=ngt, **SLICE))
    assert len(amg._host_A) == len(ref._host_A) >= 3
    for k in range(len(ref._host_A)):
        assert np.array_equal(amg._cf[k], ref._cf[k]), f"CF, level {k}"
        assert same_csr(amg._host_A[k], ref._host_A[k]), f"A, level {k}"
    for k in range(len(ref._host_A) - 1):
        assert same_csr(amg._host_P[k], ref._host_P[k]), f"P, level {k}"


def test_lcg_matches_scalar_sequence():
    g = HypreLCG(2747)
    seq = np.array([g.rand() for _ in range(1000)])
    assert np.array_equal(lcg_fill(2747, 1000), seq)
    assert np.array_equal(lcg_fill(2747, 10, skip=990), seq[990:])


def test_pmis_isolated_rows_are_fine():
    """A row with no strong connections becomes SF (-3)."""
    A = laplacian_7pt(4, 4, 4).to_scipy().tolil()
    A[5, :] = 0.0
    A[5, 5] = 6.0
    S = strength_matrix(A.tocsr())
    cf = pmis_coarsen(S)
    assert cf[5] == -3
    assert set(np.unique(cf)) <= {-3, -1, 1}
