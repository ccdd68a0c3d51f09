"""The port's LOBPCG against the JAX package's (tests/test_lobpcg.py's
cases) and scipy's eigsh.

The same operator, the same random block X0 (numpy, seeded), f64: the
same iteration count and convergence flag, the eigenvalues within 1e-12
relative of the JAX package's and 1e-6 of eigsh's, the eigenvectors the
same subspace (eigh's sign is free, so vectors are compared by the
projector X X^T); a Gram matrix that is not positive definite gives the
JAX package's NaN block and its unconverged end instead of an exception.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from hypre_tpu.models import laplacian_5pt_2d as jax_laplacian_5pt_2d
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers.eigen import LOBPCGOptions as JaxLOBPCGOptions
from hypre_tpu.solvers.eigen import lobpcg as jax_lobpcg
from hypre_tpu_torch.models import laplacian_5pt_2d, laplacian_7pt
from hypre_tpu_torch.ops import freeze_auto, spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.eigen import LOBPCGOptions, lobpcg
from torch_threads import one_thread  # noqa: F401


def columns(apply):
    """An [n] -> [n] operator applied to an [n, m] block column by column
    (each column contiguous, as the card's kernels take it)."""
    return lambda X: torch.stack(
        [apply(X[:, k].contiguous()) for k in range(X.shape[1])], dim=1)


def both(nx, m, seed, tol, max_iter, precond=None, B=None):
    """(port result, JAX result) on laplacian_5pt_2d(nx, nx)."""
    A = laplacian_5pt_2d(nx, nx)
    E = freeze_auto(A, torch.float64, "cpu")
    jE = jax_freeze_auto(jax_laplacian_5pt_2d(nx, nx))
    X0 = np.random.default_rng(seed).standard_normal((nx * nx, m))
    dinv = 1.0 / A.to_scipy().diagonal()
    T = Tj = Bt = Bj = None
    if precond == "diag":
        T = lambda R: torch.from_numpy(dinv)[:, None] * R  # noqa: E731
        Tj = lambda R: jnp.asarray(dinv)[:, None] * R  # noqa: E731
    if B is not None:
        Bt = lambda X: B * X  # noqa: E731
        Bj = lambda X: B * X  # noqa: E731
    res = lobpcg(columns(lambda x: spmv(E, x)), torch.from_numpy(X0), B=Bt,
                 T=T, opts=LOBPCGOptions(tol=tol, max_iter=max_iter))
    ref = jax_lobpcg(
        lambda X: jnp.stack([jax_spmv(jE, X[:, k]) for k in range(m)], axis=1),
        jnp.asarray(X0), B=Bj, T=Tj,
        opts=JaxLOBPCGOptions(tol=tol, max_iter=max_iter))
    return A, res, ref


def same_subspace(X, Y):
    """max |X X^T - Y Y^T| for two orthonormal blocks."""
    return float(np.abs(X @ X.T - Y @ Y.T).max())


@pytest.mark.parametrize("precond", [None, "diag"])
def test_lobpcg_matches_jax(precond):
    """tol 1e-6: the count is compared where the residuals are well above
    their rounding floor (near 1e-9 here, where the soft-locked columns'
    residuals wander and the count with them)."""
    m = 4
    A, res, ref = both(12, m, 0, 1e-6, 200, precond)
    assert res.converged and bool(ref.converged)
    assert res.num_iterations == ref.num_iterations
    lam = res.eigenvalues.numpy()
    np.testing.assert_allclose(lam, np.asarray(ref.eigenvalues), rtol=1e-12)
    w_ref = spla.eigsh(A.to_scipy(), k=m, which="SM",
                       return_eigenvectors=False)
    np.testing.assert_allclose(lam, np.sort(w_ref), rtol=1e-9)
    X = res.eigenvectors.numpy()
    assert same_subspace(X, np.asarray(ref.eigenvectors)) <= 1e-8
    assert np.abs(X.T @ X - np.eye(m)).max() <= 1e-10
    assert (res.residual_norms.numpy() < 1e-6).all()


def test_lobpcg_preconditioned_faster():
    """tests/test_lobpcg.py's preconditioned case at 16^2, m 2: the
    diagonal preconditioner, the JAX package's count."""
    _, res_plain, _ = both(16, 2, 1, 1e-6, 300)
    _, res_prec, ref = both(16, 2, 1, 1e-6, 300, "diag")
    assert res_prec.converged
    assert res_prec.num_iterations == ref.num_iterations
    assert res_prec.num_iterations <= res_plain.num_iterations + 5


def test_lobpcg_indefinite_gram_gives_nan_like_jax():
    """B = -I: the first Gram matrix X^T B X is negative definite, its
    Cholesky fails.  The block is NaN as in the JAX package, the solve
    runs to max_iter without raising and ends unconverged."""
    _, res, ref = both(6, 2, 2, 1e-8, 3, B=-1.0)
    assert not res.converged and not bool(ref.converged)
    assert res.num_iterations == ref.num_iterations == 3
    assert torch.isnan(res.eigenvalues).all()
    assert np.isnan(np.asarray(ref.eigenvalues)).all()
    assert torch.isnan(res.eigenvectors).all()


def test_lobpcg_amg_preconditioned_closed_form():
    """LOBPCG with the port's BoomerAMG V-cycle as T on laplacian_7pt(8^3),
    m 4: the four smallest eigenvalues of the closed form
    6 - 2 cos(i pi / 9) - 2 cos(j pi / 9) - 2 cos(k pi / 9), (1, 1, 1)
    and the triple (2, 1, 1)."""
    nx, m = 8, 4
    A = laplacian_7pt(nx, nx, nx)
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False,
        relocate_level2=False, collapse_coarse_n=0), device="cpu")
    E = amg.levels[0].A
    X0 = torch.from_numpy(np.random.default_rng(6).standard_normal((nx**3, m)))
    res = lobpcg(columns(lambda x: spmv(E, x)), X0, T=columns(amg.precond),
                 opts=LOBPCGOptions(tol=1e-6, max_iter=100))
    assert res.converged
    c = np.cos(np.pi / (nx + 1))
    c2 = np.cos(2 * np.pi / (nx + 1))
    want = [6 - 6 * c] + [6 - 4 * c - 2 * c2] * 3
    np.testing.assert_allclose(res.eigenvalues.numpy(), want, rtol=1e-6)
