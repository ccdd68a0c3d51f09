"""AMS, ADS and AME (hypre_tpu_torch/solvers/amg/{ams,ads,ame}.py) on
the CPU against the JAX package's: compute_pi bitwise, the auxiliary
BoomerAMG hierarchies (host A, P, CF and the lattice gates) bitwise,
the beta-is-zero decision, one preconditioner application within
1e-12, the AMS / ADS PCG solves with the same count and history, and
AME's eigenvalues (1e-10) and eigenspace (1e-8 in the sine of the
largest principal angle)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.models import maxwell as jmx
from hypre_tpu.ops.csr import CSRMatrix as JaxCSRMatrix
from hypre_tpu.solvers.amg import ads as jads
from hypre_tpu.solvers.amg import ame as jame
from hypre_tpu.solvers.amg import ams as jams
from hypre_tpu_torch.models import maxwell as mx
from hypre_tpu_torch.ops.csr import CSRMatrix
from hypre_tpu_torch.solvers.amg import ads, ame, ams
from torch_family import (chip_smoke, host, rel, same_csr, same_hierarchy,
                          same_solve)
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("shape,h", [((3, 2, 2), 1.0), ((4, 4, 4), 0.5)])
def test_compute_pi_is_the_jax_packages(shape, h):
    G, _, coords, _ = mx.edge_structure(*shape, h)
    assert same_csr(ams.compute_pi(G, coords), jams.compute_pi(G, coords))


def _ams_pair(nx, beta):
    A, G, co = mx.curlcurl_matrix(nx, nx, nx, beta=beta)
    Aj, Gj, coj = jmx.curlcurl_matrix(nx, nx, nx, beta=beta)
    return A, Aj, ams.AMS(A, G, co, device="cpu"), jams.AMS(Aj, Gj, coj)


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_ams_auxiliary_hierarchies_are_the_jax_packages(beta):
    """6^3 edges: the G-space AMG built exactly where the JAX package
    builds it (beta 0: A_G = 0, none), both auxiliary hierarchies
    bitwise with the JAX package's gates, one 01210 cycle within
    1e-12."""
    A, _, a, ja = _ams_pair(6, beta)
    assert a._beta_is_zero == ja._beta_is_zero == (beta == 0.0)
    assert (a._amg_G is None) == (ja._amg_G is None)
    if a._amg_G is not None:
        assert same_hierarchy(a._amg_G, ja._amg_G)
    assert same_hierarchy(a._amg_Pi, ja._amg_Pi)
    r = np.random.default_rng(4).standard_normal(A.num_rows)
    assert rel(a.precond(torch.from_numpy(r)),
               ja.precond(jnp.asarray(r))) <= 1e-12


def test_g_space_coarse_solve_inverts_rounding_in_both_packages():
    """An open fault of both packages (ROADMAP Queue 3).  Without
    boundary conditions A_G = G^T A G = beta G^T G is singular (the
    constants), and at 5^3 its hierarchy coarsens down to that null
    space: a 1 x 1 coarsest level holding rounding (~1e-15), which the
    coarse pinv (rcond relative to the level's own largest singular
    value) inverts.  The collapsed coarse operator then holds entries
    ~1e15 in both packages, so the G-space correction is dominated by
    amplified rounding: with bitwise equal hierarchies the two
    applications differ by O(1).  (At 6^3, 64^3 and the other sizes
    these tests and phase 16 use, the coarsest level keeps two or more
    rows and the pinv drops the null singular value.)"""
    A, _, a, ja = _ams_pair(5, 0.1)
    for amg in (a._amg_G, ja._amg_G):
        last = amg._host_A[-1].toarray()
        assert last.shape == (1, 1) and abs(last[0, 0]) < 1e-14
        assert np.abs(host(amg.levels[-1].coarse_inv.data)).max() > 1e14
    assert same_hierarchy(a._amg_G, ja._amg_G)
    r = np.random.default_rng(4).standard_normal(A.num_rows)
    assert rel(a.precond(torch.from_numpy(r)),
               ja.precond(jnp.asarray(r))) > 1e-3


def test_ams_pcg_matches_jax():
    """tests/test_ams.py's solve (6^3, beta 0.1, b = ones, tol 1e-8): the
    same count and history, x within 1e-10."""
    A, _, a, ja = _ams_pair(6, 0.1)
    b = np.ones(A.num_rows)
    res = a.solve(torch.from_numpy(b), tol=1e-8, max_iter=100)
    assert res.converged
    same_solve(res, ja.solve(jnp.asarray(b), tol=1e-8, max_iter=100))


@pytest.fixture(scope="module")
def ads_pair():
    """4^3 faces (the JAX package's ADS is slow to build even at 6^3)."""
    A, C, Pi, G, co = mx.divdiv_matrix(4, 4, 4)
    Aj, Cj, Pij, Gj, coj = jmx.divdiv_matrix(4, 4, 4)
    return (A, ads.ADS(A, C, Pi, G, co, device="cpu"),
            jads.ADS(Aj, Cj, Pij, Gj, coj))


def test_ads_matches_jax(ads_pair):
    """The curl-space AMS's and the RT nodal space's hierarchies bitwise,
    one application within 1e-12, and the PCG of tests/test_ads.py
    (seeded b, tol 1e-8) with the same count and history."""
    A, d, jd = ads_pair
    assert same_hierarchy(d._amg_Pi, jd._amg_Pi)
    assert same_hierarchy(d._ams._amg_Pi, jd._ams._amg_Pi)
    assert (d._ams._amg_G is None) == (jd._ams._amg_G is None)
    if d._ams._amg_G is not None:
        assert same_hierarchy(d._ams._amg_G, jd._ams._amg_G)
    b = np.random.default_rng(0).standard_normal(A.num_rows)
    assert rel(d.precond(torch.from_numpy(b)), jd.precond(jnp.asarray(b))) \
        <= 1e-12
    res = d.solve(torch.from_numpy(b), tol=1e-8, max_iter=100)
    assert res.converged
    same_solve(res, jd.solve(jnp.asarray(b), tol=1e-8, max_iter=100))


def test_ads_rt_space_amg_does_not_coarsen_in_both_packages(ads_pair):
    """An open fault of both packages (ROADMAP Queue 3): every
    connection of the RT nodal operator Pi^T A Pi is weak (its rows fail
    the max_row_sum 0.9 test), so its BoomerAMG keeps one level, and the
    coarse solve is a dense pinv of all 3 (n+1)^3 rows: 928 GiB at
    48^3, hence phase 16 (e) at 13^3."""
    _, d, jd = ads_pair
    for amg in (d._amg_Pi, jd._amg_Pi):
        assert len(amg._host_A) == len(amg.levels) == 1
        assert amg._host_A[0].shape == (3 * 5**3, 3 * 5**3)
        inv = amg.levels[0].coarse_inv
        assert tuple(getattr(inv, "data", inv).shape) == (375, 375)


def sin_angle(X, Y):
    """Sine of the largest principal angle between span X and span Y:
    the norm of the part of X's orthonormal basis outside span Y."""
    Qx, _ = np.linalg.qr(X)
    Qy, _ = np.linalg.qr(Y)
    return float(np.linalg.norm(Qx - Qy @ (Qy.T @ Qx), 2))


def _ame_pair(nx, **opts):
    A, G, co = mx.curlcurl_matrix(nx, nx, nx, alpha=1.0, beta=0.01)
    Aj, Gj, coj = jmx.curlcurl_matrix(nx, nx, nx, alpha=1.0, beta=0.01)
    eye = sp.eye(A.num_rows, format="csr")
    e = ame.AME(A, CSRMatrix.from_scipy(eye), G, co, ame.AMEOptions(**opts),
                device="cpu")
    res = e.solve()
    jres = jame.AME(Aj, JaxCSRMatrix.from_scipy(eye), Gj, coj,
                    jame.AMEOptions(**opts)).solve()
    assert res.converged == bool(jres.converged)
    assert res.num_iterations == int(jres.num_iterations)
    ev, evj = host(res.eigenvalues), host(jres.eigenvalues)
    assert np.abs(ev - evj).max() <= 1e-10 * np.abs(evj).max()
    assert sin_angle(host(res.eigenvectors), host(jres.eigenvectors)) <= 1e-8
    assert e.applications["A"] > 0 and len(e.inner_iterations) > 0
    return res


def test_ame_setup_and_projection_match_jax():
    """4^3, beta 0.01, M = I: the gradient-space BoomerAMG on K = G^T M G
    the same hierarchy, and one projection of a seeded 3-column block
    (per column an inner AMG-PCG, then X - G y) within 1e-12 (the whole
    LOBPCG runs under `slow` below: the JAX package's AME runs its
    columns eagerly and compiles each new shape, ~1 min on one core)."""
    A, G, co = mx.curlcurl_matrix(4, 4, 4, alpha=1.0, beta=0.01)
    Aj, Gj, coj = jmx.curlcurl_matrix(4, 4, 4, alpha=1.0, beta=0.01)
    eye = sp.eye(A.num_rows, format="csr")
    e = ame.AME(A, CSRMatrix.from_scipy(eye), G, co, device="cpu")
    je = jame.AME(Aj, JaxCSRMatrix.from_scipy(eye), Gj, coj)
    assert same_hierarchy(e._amg_K, je._amg_K)
    X = np.random.default_rng(2747).standard_normal((A.num_rows, 3))
    got = e._project(torch.from_numpy(X))
    assert rel(got, je._project(jnp.asarray(X))) <= 1e-12
    assert len(e.inner_iterations) == 3


@pytest.mark.slow
def test_ame_matches_jax():
    """tests/test_ame.py's case (4^3, beta 0.01, M = I, nev 3): converged
    in both packages with the same iteration count, the eigenvalues
    within 1e-10 relative, the eigenspace within 1e-8 (a cluster's
    vectors may come out rotated); ~1 min on one core."""
    assert _ame_pair(4, nev=3, tol=1e-6, max_iter=100).converged


@pytest.mark.slow
def test_jax_counts_at_the_card_sizes_are_the_chip_pins():
    """The JAX package's AMS-PCG at 48^3 edges, ADS-PCG at 13^3 faces
    (tol 1e-6, b = ones) and AME at 16^3 (AMEOptions(), M = I): the
    counts, the G-space decision and the eigenvalues chip_smoke.py's
    phase 16 (d)-(f) holds the card to (~18 min on a CPU, AME ~10 of
    them, ADS ~5; ~11 GB)."""
    pins = chip_smoke()
    Aj, Gj, coj = jmx.curlcurl_matrix(48, 48, 48)
    ja = jams.AMS(Aj, Gj, coj)
    res = ja.solve(jnp.ones(Aj.num_rows), tol=1e-6, max_iter=200)
    assert (int(res.num_iterations), ja._amg_G is not None) == pins.AUX_AMS48
    Aj, Cj, Pij, Gj, coj = jmx.divdiv_matrix(13, 13, 13)
    res = jads.ADS(Aj, Cj, Pij, Gj, coj).solve(jnp.ones(Aj.num_rows),
                                               tol=1e-6, max_iter=200)
    assert int(res.num_iterations) == pins.AUX_ADS13
    Aj, Gj, coj = jmx.curlcurl_matrix(16, 16, 16)
    eye = JaxCSRMatrix.from_scipy(sp.eye(Aj.num_rows, format="csr"))
    res = jame.AME(Aj, eye, Gj, coj, jame.AMEOptions()).solve()
    its, evs = pins.AUX_AME16
    assert int(res.num_iterations) == its
    assert np.abs(host(res.eigenvalues) - evs).max() <= 1e-12 * max(evs)
