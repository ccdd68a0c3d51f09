"""The coarsening family and the absolute strength test of the port
against the JAX package (hypre_tpu/solvers/amg/coarsen.py, strength.py)
on the 7-point and 27-point Laplacians and a nonsymmetric
convection-diffusion operator: the CF marker and S bitwise, and through
the whole setup the CF split, P and the coarse operators of every level
bitwise."""

import numpy as np
import pytest

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.models import laplacian_27pt as jax_laplacian_27pt
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg import coarsen as jax_coarsen
from hypre_tpu.solvers.amg.strength import strength_matrix as jax_strength
from hypre_tpu.solvers.amg.strength import \
    strength_matrix_abs as jax_strength_abs
from hypre_tpu_torch.models import difconv_7pt, laplacian_7pt, laplacian_27pt
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg import coarsen
from hypre_tpu_torch.solvers.amg.strength import (strength_matrix,
                                                  strength_matrix_abs)
from torch_threads import one_thread  # noqa: F401

PROBLEMS = {
    "7pt-10": (laplacian_7pt, jax_laplacian_7pt, (10, 10, 10)),
    "27pt-8": (laplacian_27pt, jax_laplacian_27pt, (8, 8, 8)),
    "difconv-8": (difconv_7pt, jax_difconv_7pt, (8, 8, 8)),
}
SLICE = dict(interp_type="classical", P_max_elmts=4, relax_down=18,
             relax_up=18, embed_level1=False, relocate_level2=False,
             collapse_coarse_n=0)


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def same_pattern(a, b):
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices))


def problem(name):
    port, jax, shape = PROBLEMS[name]
    return port(*shape).to_scipy().tocsr(), jax(*shape).to_scipy().tocsr()


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("fn", ["ruge_stuben_coarsen", "hmis_coarsen",
                                "cljp_coarsen", "falgout_coarsen"])
def test_cf_bitwise(name, fn):
    A, Aj = problem(name)
    assert same_csr(A, Aj)
    S = strength_matrix(A, 0.25, 0.9)
    assert same_pattern(S, jax_strength(Aj, 0.25, 0.9))
    cf = getattr(coarsen, fn)(S)
    assert np.array_equal(cf, getattr(jax_coarsen, fn)(S))
    assert set(np.unique(cf)) <= {-3, -1, 1} and (cf > 0).any()


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_cr_cf_bitwise(name):
    A, Aj = problem(name)
    cf = coarsen.cr_coarsen(A)
    assert np.array_equal(cf, jax_coarsen.cr_coarsen(Aj))
    assert 0 < (cf > 0).sum() < A.shape[0]


def test_pmis_with_cf_init_keeps_the_preset_points():
    A, _ = problem("7pt-10")
    S = strength_matrix(A)
    init = np.zeros(A.shape[0], dtype=np.int64)
    init[::7] = 1
    cf = coarsen.pmis_coarsen(S, cf_init=init)
    assert np.array_equal(cf, jax_coarsen.pmis_coarsen(S, cf_init=init))
    assert (cf[::7] == 1).all()


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("mrs", [0.9, 1.0])
def test_strength_abs_bitwise(name, mrs):
    A, Aj = problem(name)
    S = strength_matrix_abs(A, 0.25, mrs)
    assert same_pattern(S, jax_strength_abs(Aj, 0.25, mrs))
    assert S.nnz > 0


def test_strength_abs_counts_positive_couplings():
    """|a_ij| strength sees the positive off-diagonal the signed test
    skips (tests/test_options.py's 3x3 case)."""
    import scipy.sparse as sp

    M = sp.csr_matrix(np.array([[4.0, -1.0, 2.0], [-1.0, 4.0, -1.0],
                                [2.0, -1.0, 4.0]]))
    S_signed = strength_matrix(M, 0.25, 1.0)
    S_abs = strength_matrix_abs(M, 0.25, 1.0)
    assert same_pattern(S_abs, jax_strength_abs(M, 0.25, 1.0))
    assert S_abs.nnz > S_signed.nnz and S_abs[0, 2] != 0 and S_signed[0, 2] == 0


@pytest.mark.parametrize("name", ["7pt-10", "27pt-8"])
@pytest.mark.parametrize("kw", [
    dict(coarsen_type="hmis"), dict(coarsen_type="rs"),
    dict(coarsen_type="cljp"), dict(coarsen_type="falgout"),
    dict(coarsen_type="cgc"), dict(coarsen_type="cr"),
    dict(coarsen_type="pmis", strength_abs=True),
], ids=["hmis", "rs", "cljp", "falgout", "cgc", "cr", "strength_abs"])
def test_setup_bitwise(name, kw):
    """CF, P and A_c of every level equal the JAX package's."""
    port, jax, shape = PROBLEMS[name]
    amg = BoomerAMG(port(*shape), BoomerAMGOptions(**SLICE, **kw),
                    device="cpu")
    ref = JaxBoomerAMG(jax(*shape), JaxOptions(**SLICE, **kw))
    assert len(amg._host_A) == len(ref._host_A) >= 2
    for k in range(len(ref._host_A)):
        assert np.array_equal(amg._cf[k], ref._cf[k]), f"CF, level {k}"
        assert same_csr(amg._host_A[k], ref._host_A[k]), f"A, level {k}"
    for k in range(len(ref._host_A) - 1):
        assert same_csr(amg._host_P[k], ref._host_P[k]), f"P, level {k}"


def test_cljp_level_structure():
    """The port reproduces the hypre-validated CLJP hierarchy of
    `ij -laplacian -n 10 10 10 -cljp -interptype 6 -Pmx 0 -mxrs 1.0`
    (tests/test_coarsen_cljp.py's pins)."""
    amg = BoomerAMG(laplacian_7pt(10, 10, 10), BoomerAMGOptions(
        coarsen_type="cljp", interp_type="ext+i", P_max_elmts=0,
        max_row_sum=1.0, relax_down=0, relax_up=0), device="cpu")
    assert [a.shape[0] for a in amg._host_A] == [1000, 616, 324, 164, 73,
                                                 29, 8]
    assert [a.nnz for a in amg._host_A] == [6400, 8378, 27266, 21620, 5323,
                                            841, 64]
