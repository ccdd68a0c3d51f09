"""Smoothed-aggregation AMG (hypre_tpu_torch/solvers/amg/
smoothed_aggregation.py) on the CPU against the JAX package's: the
aggregates and every frozen level (A, dinv, P, R, the coarsest pinv)
bitwise, one V-cycle within 1e-12 with a DIA fine level, and the PCG of
tests/test_sa_amg.py with the same count and history."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hypre_tpu.models as jm
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers import krylov as jk
from hypre_tpu.solvers.amg import smoothed_aggregation as jsa
from hypre_tpu.solvers.amg.strength import strength_matrix as jax_strength
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.ops.dia import freeze_auto, spmv
from hypre_tpu_torch.solvers.amg import smoothed_aggregation as sa
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_family import chip_smoke, host, rel, same_dense, same_solve
from torch_threads import one_thread  # noqa: F401

PROBLEMS = {"laplacian": (pm.laplacian_7pt, jm.laplacian_7pt),
            "difconv": (pm.difconv_7pt, jm.difconv_7pt)}


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("theta", [0.08, 0.25])
def test_aggregate_is_the_jax_packages(kind, theta):
    A = PROBLEMS[kind][0](8, 8, 8)
    S = strength_matrix(A, theta, 1.0)
    Sj = jax_strength(A.to_scipy(), theta, 1.0)
    assert np.array_equal(sa._aggregate(S), jsa._aggregate(Sj))


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
def test_sa_levels_are_the_jax_packages(kind):
    """10^3: every level dense, each frozen operator bitwise; the port's
    host aggregates those of the JAX package's function."""
    port, jax_ = PROBLEMS[kind]
    amg = sa.SmoothedAggregationAMG(port(10, 10, 10), device="cpu")
    jamg = jsa.SmoothedAggregationAMG(jax_(10, 10, 10))
    assert amg.num_levels == jamg.num_levels >= 2
    for lv, jlv, hl in zip(amg.levels, jamg.levels, amg.host_levels):
        assert same_dense(lv["A"], jlv["A"])
        assert np.array_equal(host(lv["dinv"]), host(jlv["dinv"]))
        if jlv["P"] is None:
            assert lv["P"] is None
            assert np.array_equal(host(lv["coarse_inv"]),
                                  host(jlv["coarse_inv"]))
            continue
        assert same_dense(lv["P"], jlv["P"]) and same_dense(lv["R"], jlv["R"])
        S = jax_strength(hl["A"], amg.opts.theta, 1.0)
        assert np.array_equal(hl["agg"], jsa._aggregate(S))


def test_sa_cycle_matches_jax_with_a_dia_fine_level():
    """20^3: level 0 frozen as DIA (the K1 path on the card), its P and R
    as ELL; one cycle within 1e-12."""
    amg = sa.SmoothedAggregationAMG(pm.laplacian_7pt(20, 20, 20), device="cpu")
    jamg = jsa.SmoothedAggregationAMG(jm.laplacian_7pt(20, 20, 20))
    assert type(amg.levels[0]["A"]).__name__ == "DIAMatrix"
    r = np.random.default_rng(5).standard_normal(8000)
    z = amg.cycle(torch.from_numpy(r))
    assert rel(z, jamg.cycle(jnp.asarray(r))) <= 1e-12
    launches = amg.cycle_launches()
    # A: two sweeps and the residual; R and P (8000 rows, ELL) once each
    assert launches == {"dia_spmv": 3, "ell_spmv": 2}


def _pcg(A, amg, b, tol, max_iter):
    E = freeze_auto(A, torch.float64, "cpu")
    return pcg(lambda x: spmv(E, x), torch.from_numpy(b), M=amg.precond,
               opts=PCGOptions(tol=tol, max_iter=max_iter))


def _jax_pcg(Aj, jamg, b, tol, max_iter):
    Ej = jax_freeze_auto(Aj)
    return jk.pcg(lambda x: jax_spmv(Ej, x), jnp.asarray(b), M=jamg.precond,
                  opts=jk.PCGOptions(tol=tol, max_iter=max_iter))


def test_sa_pcg_matches_jax():
    """tests/test_sa_amg.py's case: 12^3, tol 1e-9, the same count (at
    most 25) and history, x within 1e-10 and the direct solution."""
    A, Aj = pm.laplacian_7pt(12, 12, 12), jm.laplacian_7pt(12, 12, 12)
    b = np.ones(A.num_rows)
    res = _pcg(A, sa.SmoothedAggregationAMG(A, device="cpu"), b, 1e-9, 100)
    jres = _jax_pcg(Aj, jsa.SmoothedAggregationAMG(Aj), b, 1e-9, 100)
    assert res.converged and same_solve(res, jres) <= 25
    x_ref = spla.spsolve(A.to_scipy().tocsc(), b)
    np.testing.assert_allclose(host(res.x), x_ref, rtol=1e-6)


@pytest.mark.slow
def test_jax_count_at_96_is_the_chip_pin():
    """The JAX package's SA-PCG count at 96^3 (tol 1e-6, b = ones), the
    count chip_smoke.py's phase 16 (a) holds the card to (~1 min)."""
    Aj = jm.laplacian_7pt(96, 96, 96)
    b = np.ones(Aj.num_rows)
    jres = _jax_pcg(Aj, jsa.SmoothedAggregationAMG(Aj), b, 1e-6, 200)
    assert bool(jres.converged)
    assert int(jres.num_iterations) == chip_smoke().AUX_SA96
