"""The interpolation family, the aggressive round's building blocks,
Jacobi post-interpolation and AIR restriction of the port against the
JAX package (hypre_tpu/ops/matops.py, solvers/amg/strength.py,
coarsen.py, interp.py) on the same inputs: every product bitwise (max
abs diff 0.0), the CF marker, P, R and the coarse operators of every
level through the whole setup too; the JAX package's oracle pins of
standard, FF and FF1 interpolation (tests/test_parity_ij.py:86-130)
and of the matops (tests/test_spmv.py:147)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.models import laplacian_27pt as jax_laplacian_27pt
from hypre_tpu.ops import matops as jax_matops
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg import coarsen as jax_coarsen
from hypre_tpu.solvers.amg import interp as jax_interp
from hypre_tpu.solvers.amg import strength as jax_strength
from hypre_tpu_torch.models import difconv_7pt, laplacian_7pt, laplacian_27pt
from hypre_tpu_torch.ops import matops
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg import coarsen, interp
from hypre_tpu_torch.solvers.amg.strength import (second_strength,
                                                  strength_matrix)
from torch_threads import one_thread  # noqa: F401

PROBLEMS = {
    "7pt-10": (laplacian_7pt, jax_laplacian_7pt, (10, 10, 10)),
    "27pt-8": (laplacian_27pt, jax_laplacian_27pt, (8, 8, 8)),
    "difconv-8": (difconv_7pt, jax_difconv_7pt, (8, 8, 8)),
}
SLICE = dict(coarsen_type="pmis", P_max_elmts=4, relax_down=18,
             relax_up=18, embed_level1=False, relocate_level2=False,
             collapse_coarse_n=0)
NEW_INTERP = ["direct", "multipass", "standard", "standard-sep", "ff", "ff1",
              "ext"]


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def split(name):
    """(A, S, CF) of a problem: the port's A (equal to the JAX
    package's), its strength graph and its PMIS split."""
    port, jax, shape = PROBLEMS[name]
    A = port(*shape).to_scipy().tocsr()
    assert same_csr(A, jax(*shape).to_scipy())
    S = strength_matrix(A, 0.25, 0.9)
    return A, S, coarsen.pmis_coarsen(S)


# -- 1. matops ---------------------------------------------------------------

def test_matops_bool_aat_fffc():
    """bool_multiply / aat / fffc_split bitwise the JAX package's, and
    its own checks (tests/test_spmv.py:147)."""
    A = laplacian_7pt(4, 4, 3).to_scipy()
    B = matops.bool_multiply(A, A)
    assert same_csr(B, jax_matops.bool_multiply(A, A))
    assert set(np.unique(B.data)) == {1}
    assert (B != 0).nnz == ((A @ A) != 0).nnz
    C = matops.aat(A)
    assert same_csr(C, jax_matops.aat(A))
    assert abs(C - A @ A.T).max() < 1e-12
    cf = np.where(np.arange(A.shape[0]) % 3 == 0, 1, -1)
    blocks = matops.fffc_split(A, cf)
    for mine, ref in zip(blocks, jax_matops.fffc_split(A, cf)):
        assert same_csr(mine, ref)
    FF, FC, CF, CC = blocks
    nf, nc = (cf <= 0).sum(), (cf > 0).sum()
    assert FF.shape == (nf, nf) and CC.shape == (nc, nc)
    assert FC.shape == (nf, nc) and CF.shape == (nc, nf)
    assert FF.nnz + FC.nnz + CF.nnz + CC.nnz == A.nnz


# -- 2-3. the aggressive round's graph and its coarsening -------------------

@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("num_paths", [1, 2, 3])
def test_second_strength_bitwise(name, num_paths):
    A, S, cf = split(name)
    S2 = second_strength(S, cf, num_paths)
    assert same_csr(S2, jax_strength.second_strength(S, cf, num_paths))
    assert S2.shape == ((cf > 0).sum(),) * 2
    assert S2.diagonal().sum() == 0


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("num_paths", [1, 2])
def test_second_round_pmis_bitwise(name, num_paths):
    """PMIS with CF_init 3: S2-isolated points stay C."""
    A, S, cf = split(name)
    S2 = second_strength(S, cf, num_paths)
    cf2 = coarsen.pmis_coarsen(S2, isolated_to_c=True)
    assert np.array_equal(cf2, jax_coarsen.pmis_coarsen(
        S2, isolated_to_c=True))
    isolated = np.diff(S2.indptr) == 0
    assert (cf2[isolated] == 1).all() and -3 not in cf2
    plain = coarsen.pmis_coarsen(S2)
    assert np.array_equal(plain, jax_coarsen.pmis_coarsen(S2))


# -- 4. helpers --------------------------------------------------------------

@pytest.mark.parametrize("name", list(PROBLEMS))
def test_helpers_bitwise(name):
    A, S, cf = split(name)
    for mine, ref in zip(interp._split(A), jax_interp._split(A)):
        assert np.array_equal(mine, ref)
    assert np.array_equal(interp._pattern_mask(A, S),
                          jax_interp._pattern_mask(A, S))
    rng = np.random.default_rng(3)
    rows = rng.integers(0, A.shape[0], 200)
    cols = rng.integers(0, A.shape[0], 200)
    A.sort_indices()
    got = interp._csr_lookup(A, rows, cols)
    assert np.array_equal(got, jax_interp._csr_lookup(A, rows, cols))
    assert np.array_equal(got, np.asarray(A[rows, cols]).ravel())


# -- 5-8. the interpolations -------------------------------------------------

INTERP_FNS = {
    "direct": lambda m: m.direct_interp,
    "multipass": lambda m: m.multipass_interp,
    "standard": lambda m: m.standard_interp,
    "standard-sep": lambda m: lambda A, S, cf: m.standard_interp(
        A, S, cf, sep_weight=True),
    "ff": lambda m: m.ff_interp,
    "ff1": lambda m: lambda A, S, cf: m.ff_interp(A, S, cf, ff1=True),
    "ext": lambda m: m.extended_interp,
}


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("kind", NEW_INTERP)
def test_interp_bitwise(name, kind):
    """P of each new interpolation on the same (A, S, CF)."""
    A, S, cf = split(name)
    P = INTERP_FNS[kind](interp)(A, S, cf)
    ref = INTERP_FNS[kind](jax_interp)(A, S, cf)
    assert same_csr(P, ref)
    nc = int((cf > 0).sum())
    assert P.shape == (A.shape[0], nc) and np.isfinite(P.data).all()
    # C rows inject
    c = np.flatnonzero(cf > 0)
    assert np.array_equal(P[c].toarray(), np.eye(nc))


def test_multipass_on_the_aggressive_split():
    """Multipass over the combined CF marker of the aggressive round
    (pass 2 and beyond reach F points with no strong C neighbour)."""
    A, S, cf = split("7pt-10")
    cf2 = coarsen.pmis_coarsen(second_strength(S, cf), isolated_to_c=True)
    cidx = np.flatnonzero(cf > 0)
    agg = np.where(cf > 0, -1, cf)
    agg[cidx[cf2 > 0]] = 1
    P = interp.multipass_interp(A, S, agg)
    assert same_csr(P, jax_interp.multipass_interp(A, S, agg))
    for max_passes in (2, 3):
        assert same_csr(interp.multipass_interp(A, S, agg, max_passes),
                        jax_interp.multipass_interp(A, S, agg, max_passes))
    # multipass keeps row sums <= 1 on the M-matrix (the JAX package's
    # tests/test_multipass.py check)
    assert np.asarray(P.sum(axis=1)).max() <= 1.0 + 1e-12


@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("trunc", [(0.0, 4), (0.2, 0), (0.1, 3)])
def test_truncation_of_new_interps_bitwise(name, trunc):
    A, S, cf = split(name)
    for kind in ("standard", "ff1", "multipass"):
        P = interp.truncate_interp(INTERP_FNS[kind](interp)(A, S, cf), *trunc)
        ref = jax_interp.truncate_interp(
            INTERP_FNS[kind](jax_interp)(A, S, cf), *trunc)
        assert same_csr(P, ref)


# -- 9. Jacobi post-interpolation --------------------------------------------

@pytest.mark.parametrize("name", list(PROBLEMS))
@pytest.mark.parametrize("steps,thr", [(1, 0.01), (2, 0.01), (1, 0.1)])
def test_jacobi_interp_bitwise(name, steps, thr):
    A, S, cf = split(name)
    P0 = interp.truncate_interp(interp.classical_interp(A, S, cf), 0.0, 4)
    P = interp.jacobi_interp(A, P0, cf, steps, thr)
    assert same_csr(P, jax_interp.jacobi_interp(A, P0, cf, steps, thr))
    assert P.shape == P0.shape and (abs(P - P0) > 0).nnz > 0


# -- 10. AIR -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["difconv-8", "7pt-10"])
@pytest.mark.parametrize("kw", [
    dict(distance=1), dict(distance=2),
    dict(distance=2, neumann_degree=2), dict(distance=1, neumann_degree=0),
    dict(distance=1, filter_threshold=0.05),
], ids=["air1", "air2", "neumann2", "neumann0", "filter"])
def test_air_restriction_bitwise(name, kw):
    A, S, cf = split(name)
    R = interp.air_restriction(A, S, cf, **kw)
    assert same_csr(R, jax_interp.air_restriction(A, S, cf, **kw))
    nc = int((cf > 0).sum())
    assert R.shape == (nc, A.shape[0])
    # each C row carries its own point with weight 1
    c = np.flatnonzero(cf > 0)
    assert np.array_equal(np.asarray(R[np.arange(nc), c]).ravel(),
                          np.ones(nc))


def test_air_is_not_p_transpose():
    A, S, cf = split("difconv-8")
    R = interp.air_restriction(A, S, cf)
    PT = interp.classical_interp(A, S, cf).T.tocsr()
    assert abs(R - PT).max() > 1e-2


# -- 11. the setup loop: every level bitwise ---------------------------------

def assert_hierarchies_equal(amg, ref):
    assert len(amg._host_A) == len(ref._host_A) >= 2
    for k in range(len(ref._host_A)):
        assert same_csr(amg._host_A[k], ref._host_A[k]), k
        if k < len(ref._host_A) - 1:
            assert np.array_equal(amg._cf[k], ref._cf[k]), k
            assert same_csr(amg._host_P[k], ref._host_P[k]), k
            assert (amg._host_R[k] is None) == (ref._host_R[k] is None), k
            if ref._host_R[k] is not None:
                assert same_csr(amg._host_R[k], ref._host_R[k]), k


@pytest.mark.parametrize("name", ["7pt-10", "difconv-8"])
@pytest.mark.parametrize("kw", [dict(interp_type=t) for t in NEW_INTERP] + [
    dict(interp_type="classical", post_interp_type=1),
    dict(interp_type="ext+i", post_interp_type=2,
         jacobi_trunc_threshold=0.05),
    dict(interp_type="classical", restrict_type=1),
    dict(interp_type="classical", restrict_type=2, filter_threshold_r=0.05),
    dict(interp_type="classical", restrict_type=2, air_neumann_degree=2),
], ids=NEW_INTERP + ["post1", "post2", "air1", "air2_filter", "neumann2"])
def test_setup_bitwise(name, kw):
    """CF, P, R and A_c of every level equal the JAX package's."""
    port, jax, shape = PROBLEMS[name]
    opts = dict(SLICE, **kw)
    amg = BoomerAMG(port(*shape), BoomerAMGOptions(**opts), device="cpu")
    ref = JaxBoomerAMG(jax(*shape), JaxOptions(**opts))
    assert_hierarchies_equal(amg, ref)
    if kw.get("restrict_type"):
        assert all(R is not None for R in amg._host_R)


# -- the JAX package's oracle pins (tests/test_parity_ij.py:86-130) ---------

@pytest.mark.parametrize("kind,relax,pin", [
    ("standard", (13, 14), 15), ("standard-sep", (13, 14), 15),
    ("ff", (18, 18), None), ("ff1", (18, 18), None),
])
def test_oracle_cases_at_10(kind, relax, pin):
    """The 10^3 oracle cases: the port solves in the JAX package's
    iterations with its residual history (1e-10 relative above 1e-4 of
    the first residual, 1e-14 of the first everywhere); standard and
    standard-sep within the oracle's 14 (+1)."""
    opts = dict(coarsen_type="pmis", interp_type=kind, P_max_elmts=4,
                max_row_sum=1.0, relax_down=relax[0], relax_up=relax[1],
                embed_level1=False)
    A = laplacian_7pt(10, 10, 10)
    b = A.to_scipy() @ np.ones(1000)
    amg = BoomerAMG(A, BoomerAMGOptions(**opts), device="cpu")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(10, 10, 10), JaxOptions(**opts))
    assert_hierarchies_equal(amg, jamg)
    res = amg.solve(torch.from_numpy(b), tol=1e-8, max_iter=40)
    ref = jamg.solve(jnp.asarray(b), tol=1e-8, max_iter=40)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    a, r = res.res_norms.numpy(), np.asarray(ref.res_norms)
    ok = ~np.isnan(r)
    assert np.array_equal(np.isnan(a), np.isnan(r))
    early = ok & (r >= 1e-4 * r[0])
    assert np.max(np.abs(a[early] - r[early]) / r[early]) <= 1e-10
    assert np.abs(a[ok] - r[ok]).max() <= 1e-14 * r[0]
    if pin is not None:
        assert res.num_iterations <= pin
