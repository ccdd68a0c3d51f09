"""The port's Chebyshev smoother (relax 16) against the JAX package, on
the CPU: the eigenvalue estimate and coefficients bitwise (the same
numpy arithmetic), one smoothing step within 1e-12 in f64 on the DIA,
ELL and dense forms, and PCG at 24^3 to the JAX package's count with
its residual history within 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops import CSRMatrix as JaxCSR
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg import relax as jrelax
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, freeze_auto, spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.relax import (_cheby_std_coefs, cheby_setup,
                                               chebyshev, max_eig_estimate_cg)
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

CHEBY = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=16, relax_up=16, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0, dtype="float64")


def _matrix(n=10):
    M = laplacian_7pt(n, n, n).to_scipy().tocsr()
    # a non-constant diagonal, so the D^{-1/2} scaling matters
    M = M + 0.5 * np.diag(np.linspace(0.0, 1.0, M.shape[0]))
    return np.asarray(M)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("iters", [3, 10])
def test_max_eig_estimate_cg_bitwise(scale, iters):
    import scipy.sparse as sp

    M = sp.csr_matrix(_matrix(8))
    got = max_eig_estimate_cg(CSRMatrix.from_scipy(M), scale, iters)
    want = jrelax.max_eig_estimate_cg(JaxCSR.from_scipy(M), scale, iters)
    assert got == want


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_cheby_std_coefs_bitwise(order):
    got = _cheby_std_coefs(order, 1.3, 0.7)
    assert np.array_equal(got, jrelax._cheby_std_coefs(order, 1.3, 0.7))


@pytest.mark.parametrize("order,ratio", [(1, 0.3), (2, 0.3), (3, 0.1),
                                         (4, 0.5), (7, 0.3)])
def test_cheby_setup_bitwise(order, ratio):
    import scipy.sparse as sp

    M = sp.csr_matrix(_matrix(8))
    got = cheby_setup(CSRMatrix.from_scipy(M), order, ratio, device="cpu")
    want = jrelax.cheby_setup(JaxCSR.from_scipy(M), order, ratio)
    assert got.order == want.order == min(order, 4)
    assert np.array_equal(np.array(got.coefs), np.asarray(want.coefs))
    assert np.array_equal(got.dsqrtinv.numpy(), np.asarray(want.dsqrtinv))
    assert got.dsqrtinv.dtype == torch.float64


@pytest.mark.parametrize("fmt,n", [("dia", 20), ("ell", 1), ("dense", 10)])
@pytest.mark.parametrize("order", [2, 4])
def test_chebyshev_matches_jax(fmt, n, order):
    """One smoothing step, f64, within 1e-12 of the JAX package's, on a
    frozen operator of each form (an ELL operator: a random sparse SPD
    matrix too irregular for DIA)."""
    import scipy.sparse as sp

    if fmt == "ell":
        rng = np.random.default_rng(9)
        B = sp.random(7000, 7000, 8 / 7000, random_state=rng)
        M = (B + B.T + sp.diags(20.0 + rng.random(7000))).tocsr()
    else:
        M = laplacian_7pt(n, n, n).to_scipy().tocsr()
    M.sort_indices()
    A = freeze_auto(CSRMatrix.from_scipy(M), torch.float64, "cpu")
    assert type(A).__name__.lower().startswith(fmt)
    cd = cheby_setup(CSRMatrix.from_scipy(M), order, device="cpu")
    jcd = jrelax.cheby_setup(JaxCSR.from_scipy(M), order)
    from hypre_tpu.ops.dia import freeze_auto as jax_freeze

    jA = jax_freeze(JaxCSR.from_scipy(M))
    rng = np.random.default_rng(1)
    u, f = rng.standard_normal(M.shape[0]), rng.standard_normal(M.shape[0])
    got = chebyshev(A, cd, torch.from_numpy(u), torch.from_numpy(f)).numpy()
    want = np.asarray(jrelax.chebyshev(jA, jcd, jnp.asarray(u), jnp.asarray(f)))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.fixture(scope="module")
def jax_cheby():
    amg = JaxBoomerAMG(jax_laplacian_7pt(24, 24, 24), JaxOptions(**CHEBY))
    levels = unview(list(amg.levels))
    res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(24**3),
                  M=lambda r: amg.cycle(r, levels=levels),
                  opts=JaxPCGOptions(tol=1e-6, max_iter=80, two_norm=True))
    return amg, jax.tree.map(np.asarray, levels), res


def test_cheby_pcg_matches_jax(jax_cheby):
    """relax 16 at 24^3 from the port's own setup: the JAX package's count
    (10) and residual history within 1e-10."""
    _, _, ref = jax_cheby
    amg = BoomerAMG(laplacian_7pt(24, 24, 24), BoomerAMGOptions(**CHEBY),
                    device="cpu")
    assert all(l.cheby is not None for l in amg.levels[:-1])
    A0 = amg.levels[0].A
    res = pcg(lambda x: spmv(A0, x), torch.ones(24**3, dtype=torch.float64),
              M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=80, two_norm=True))
    assert res.num_iterations == int(ref.num_iterations) == 10
    a, b = res.res_norms.numpy(), np.asarray(ref.res_norms)
    ok = ~np.isnan(b)
    assert np.array_equal(np.isnan(a), ~ok)
    assert np.max(np.abs(a[ok] - b[ok]) / b[ok]) <= 1e-10


def test_cheby_cycle_over_carried_levels(jax_cheby):
    """levels_from_numpy carries the Chebyshev data: the port's V-cycle
    over the JAX package's levels within 1e-12 of its cycle."""
    jamg, levels, _ = jax_cheby
    amg = BoomerAMG.from_levels(levels_from_numpy(levels, "cpu"),
                                BoomerAMGOptions(**CHEBY), device="cpu")
    assert amg.levels[0].cheby.coefs == tuple(
        float(c) for c in levels[0].cheby.coefs)
    f = np.random.default_rng(4).standard_normal(24**3)
    ref = np.asarray(jamg.cycle(jnp.asarray(f)))
    z = amg.cycle(torch.from_numpy(f)).numpy()
    assert np.abs(z - ref).max() <= 1e-12 * np.abs(ref).max()


def test_cheby_f32_keeps_the_vector_dtype():
    """f32 vectors with bf16 matrices: the polynomial runs in the f64
    coefficients, the matvecs in f32, and the cycle returns f32; PCG
    converges at 16^3."""
    amg = BoomerAMG(laplacian_7pt(16, 16, 16), BoomerAMGOptions(
        **{**CHEBY, "dtype": "float32", "mat_dtype": "bfloat16"}), device="cpu")
    z = amg.cycle(torch.ones(16**3, dtype=torch.float32))
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    A0 = amg.levels[0].A
    res = pcg(lambda x: spmv(A0, x), torch.ones(16**3), M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=80, two_norm=True))
    assert res.converged
