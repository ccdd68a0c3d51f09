"""ILU (hypre_tpu_torch/solvers/amg/ilu.py) and AMGHybrid (hybrid.py) on
the CPU against the JAX package's: the ILU(0) / ILU(k) / ILUT factors
bitwise, ILU.solve (the triangular pair through the GS schedules) to
1e-12, SchurILU's apply to 1e-12, and both AMGHybrid cases of
tests/test_hybrid.py (the same count in each phase, x to 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.solvers.amg import ilu as jax_ilu
from hypre_tpu.solvers.amg.hybrid import AMGHybrid as JaxAMGHybrid
from hypre_tpu.solvers.amg.hybrid import AMGHybridOptions as JaxHybridOptions
from hypre_tpu_torch.models import difconv_7pt, laplacian_7pt
from hypre_tpu_torch.solvers.amg import ilu
from hypre_tpu_torch.solvers.amg.hybrid import AMGHybrid, AMGHybridOptions
from torch_threads import one_thread  # noqa: F401

PROBLEMS = {"laplacian": (laplacian_7pt, jax_laplacian_7pt),
            "difconv": (difconv_7pt, jax_difconv_7pt)}


def _pair(kind, n=6):
    port, jax_ = PROBLEMS[kind]
    return port(n, n, n), jax_(n, n, n)


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("method", ["ilu0", "iluk1", "iluk2", "ilut"])
def test_factors_are_the_jax_packages(kind, method):
    A, _ = _pair(kind)
    As = A.to_scipy()
    if method == "ilu0":
        got, ref = ilu.ilu0_factor(As), jax_ilu.ilu0_factor(As)
    elif method == "ilut":
        got, ref = ilu.ilut_factor(As, 0.01, 20), jax_ilu.ilut_factor(
            As, 0.01, 20)[:2]
    else:
        k = int(method[-1])
        got, ref = ilu.iluk_factor(As, k), jax_ilu.iluk_factor(As, k)
    assert _same_csr(got[0], ref[0]) and _same_csr(got[1], ref[1])


@pytest.mark.parametrize("kind", sorted(PROBLEMS))
@pytest.mark.parametrize("opts", [dict(), dict(fill_level=1),
                                  dict(type=1, droptol=0.001)],
                         ids=["ilu0", "iluk1", "ilut"])
def test_ilu_solve_matches_jax(kind, opts):
    A, Aj = _pair(kind)
    r = np.random.default_rng(4).standard_normal(A.num_rows)
    ref = np.asarray(jax_ilu.ILU(Aj, jax_ilu.ILUOptions(**opts)).solve(
        jnp.asarray(r)))
    got = ilu.ILU(A, ilu.ILUOptions(**opts), device="cpu").solve(
        torch.from_numpy(r)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_schur_ilu_matches_jax():
    A, Aj = _pair("difconv", 8)
    r = np.random.default_rng(8).standard_normal(A.num_rows)
    opts = dict(num_domains=4, fill_level=1)
    s = ilu.SchurILU(A, ilu.SchurILUOptions(**opts), device="cpu")
    sj = jax_ilu.SchurILU(Aj, jax_ilu.SchurILUOptions(**opts))
    assert np.array_equal(s.ifc_idx, sj.ifc_idx)
    ref = np.asarray(sj.solve(jnp.asarray(r)))
    got = s.solve(torch.from_numpy(r)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("n,kw,switched", [
    (6, dict(tol=1e-8), False),
    (12, dict(tol=1e-10, cf_tol=0.5), True),
], ids=["stays_dscg", "switches"])
def test_amg_hybrid_matches_jax(n, kw, switched):
    """tests/test_hybrid.py's two cases: DSCG alone, and the switch to
    AMG-PCG on cf_tol 0.5."""
    A, Aj = laplacian_7pt(n, n, n), jax_laplacian_7pt(n, n, n)
    hj = JaxAMGHybrid(Aj, JaxHybridOptions(**kw))
    ref = hj.solve(jnp.ones(n**3))
    h = AMGHybrid(A, AMGHybridOptions(**kw), device="cpu")
    res = h.solve(torch.ones(n**3, dtype=torch.float64))
    assert res.converged and bool(ref.converged)
    assert (h._amg is not None) == (hj._amg is not None) == switched
    assert res.num_iterations == int(ref.num_iterations)
    assert len(h.phase_iterations) == (2 if switched else 1)
    x, xr = res.x.numpy(), np.asarray(ref.x)
    assert np.abs(x - xr).max() <= 1e-12 * np.abs(xr).max()
