"""The port's PCG against the JAX package's, option by option (the
pcg.c semantics: energy/two-norm tests, a_tol, rel_change,
recompute_residual(_p), rtol, cf_tol, zero rhs, max_iter).

Both solve the 7-point Laplacian at 6^3 with a Jacobi preconditioner in
f64 from the same right-hand side; iteration counts must be equal and
the residual histories, solutions and final relative residuals agree
to 1e-10 of their largest entries (dot products are summed in another
order by XLA and torch).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

CASES = {
    "energy": dict(tol=1e-8),
    "two_norm": dict(tol=1e-8, two_norm=True),
    "a_tol": dict(tol=0.0, a_tol=1e-6, two_norm=True),
    "rel_change": dict(tol=1e-8, two_norm=True, rel_change=True),
    "recompute_residual": dict(tol=1e-8, recompute_residual=True),
    "recompute_residual_p": dict(tol=1e-8, two_norm=True, recompute_residual_p=3),
    "rtol_two_norm": dict(tol=1e-12, two_norm=True, rtol=1e-3),
    "rtol_energy": dict(tol=1e-12, rtol=1e-3),
    "cf_tol": dict(tol=1e-12, cf_tol=0.3),
    "max_iter": dict(tol=1e-14, max_iter=5),
}


@pytest.mark.parametrize("case", list(CASES) + ["zero_rhs"])
def test_pcg_options_match_jax(case):
    kw = dict(CASES.get(case, dict(tol=1e-8)))
    max_iter = kw.pop("max_iter", 100)
    A = laplacian_7pt(6, 6, 6).to_scipy().toarray()
    n = A.shape[0]
    dinv = 1.0 / np.diag(A)
    b = (np.zeros(n) if case == "zero_rhs"
         else np.random.default_rng(4).standard_normal(n))
    ref = jax_pcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                  M=lambda r: jnp.asarray(dinv) * r,
                  opts=JaxPCGOptions(max_iter=max_iter, **kw))
    A_t, dinv_t = torch.from_numpy(A), torch.from_numpy(dinv)
    res = pcg(lambda x: A_t @ x, torch.from_numpy(b), M=lambda r: dinv_t * r,
              opts=PCGOptions(max_iter=max_iter, **kw))
    assert res.num_iterations == int(ref.num_iterations)
    assert res.converged == bool(ref.converged)
    h, h_ref = res.res_norms.numpy(), np.asarray(ref.res_norms)
    assert np.array_equal(np.isnan(h), np.isnan(h_ref))
    ok = ~np.isnan(h)
    scale = max(np.abs(h_ref[ok]).max(), 1e-300)
    assert np.abs(h[ok] - h_ref[ok]).max() <= 1e-10 * scale
    x, x_ref = res.x.numpy(), np.asarray(ref.x)
    assert np.abs(x - x_ref).max() <= 1e-10 * max(np.abs(x_ref).max(), 1.0)
    # relative to ||b||-scaled quantities of order 1, as the history is
    assert abs(float(res.rel_residual_norm) - float(ref.rel_residual_norm)) <= 1e-10
