"""The Maxwell problem generators (hypre_tpu_torch/models/maxwell.py) on
the CPU against the JAX package's: the discrete gradient G, the curl C,
the node coordinates, the RT0 interpolation Pi and the curl-curl and
div-div operators, bitwise; and the identities the auxiliary-space
solvers rely on."""

import numpy as np
import pytest

from hypre_tpu.models import maxwell as jax_maxwell
from hypre_tpu_torch.models import maxwell
from torch_threads import one_thread  # noqa: F401


def same_csr(a, b):
    """Two CSR matrices (either package's CSRMatrix or scipy) bit for
    bit: shape, index arrays and values."""
    a = a.to_scipy() if hasattr(a, "to_scipy") else a.tocsr()
    b = b.to_scipy() if hasattr(b, "to_scipy") else b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data)
            and a.data.dtype == b.data.dtype)


SHAPES = [(4, 3, 2), (3, 3, 3), (5, 1, 2)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("h", [1.0, 0.25])
def test_edge_structure_is_the_jax_packages(shape, h):
    G, C, coords, ne = maxwell.edge_structure(*shape, h)
    Gj, Cj, coords_j, ne_j = jax_maxwell.edge_structure(*shape, h)
    assert ne == ne_j and same_csr(G, Gj) and same_csr(C, Cj)
    assert np.array_equal(coords, coords_j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (1.0, 0.01), (2.0, 0.0)])
def test_curlcurl_matrix_is_the_jax_packages(shape, alpha, beta):
    A, G, coords = maxwell.curlcurl_matrix(*shape, alpha=alpha, beta=beta)
    Aj, Gj, coords_j = jax_maxwell.curlcurl_matrix(*shape, alpha=alpha,
                                                   beta=beta)
    assert same_csr(A, Aj) and same_csr(G, Gj)
    assert np.array_equal(coords, coords_j)


@pytest.mark.parametrize("shape", SHAPES)
def test_face_structure_and_divdiv_are_the_jax_packages(shape):
    C, Pi, nf, G, coords = maxwell.face_structure(*shape, h=0.5)
    Cj, Pij, nf_j, Gj, coords_j = jax_maxwell.face_structure(*shape, h=0.5)
    assert nf == nf_j and same_csr(C, Cj) and same_csr(Pi, Pij)
    assert same_csr(G, Gj) and np.array_equal(coords, coords_j)
    out = maxwell.divdiv_matrix(*shape, alpha=1.0, beta=0.5)
    ref = jax_maxwell.divdiv_matrix(*shape, alpha=1.0, beta=0.5)
    for got, want in zip(out[:4], ref[:4]):
        assert same_csr(got, want)
    assert np.array_equal(out[4], ref[4])


def test_curl_of_grad_is_zero_and_the_operators_are_symmetric():
    """C G = 0 (the structure-preserving identity AMS relies on), and the
    curl-curl and div-div operators are symmetric."""
    G, C, _, _ = maxwell.edge_structure(4, 3, 2)
    assert abs(C.to_scipy() @ G.to_scipy()).max() == 0.0
    A, _, _ = maxwell.curlcurl_matrix(3, 3, 3, alpha=1.0, beta=0.5)
    D, _, _, _, _ = maxwell.divdiv_matrix(3, 3, 3)
    for M in (A.to_scipy(), D.to_scipy()):
        assert abs(M - M.T).max() < 1e-14
