"""The port's Krylov family (blas1, GMRES, FlexGMRES, LGMRES, COGMRES,
BiCGSTAB, CGNR) against the JAX package's, solver by solver.

Both packages solve the same nonsymmetric operator (difconv_7pt at
10^3) from the same right-hand side in f64, preconditioned by a
BoomerAMG V-cycle (ext+i, P_max_elmts 4, l1-Jacobi, the plain forms:
each package's own setup, bitwise the same hierarchy) or by the
diagonal.  Iteration counts and convergence flags must be equal, the
residual histories agree within 1e-10 of their largest entry (XLA and
torch sum dot products in another order), x and the final relative
residual likewise.  The edge cases are those of the JAX package's tests
(tests/test_krylov.py, tests/test_krylov_family.py): a zero right-hand
side, max_iter reached, the stall guard (a cycle that takes no step,
k_dim 0), COGMRES with CGS-2; f32 histories agree within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.ops import blas1 as jax_blas1
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers import krylov as jk
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu_torch.models import difconv_7pt
from hypre_tpu_torch.ops import blas1, freeze_auto, spmv
from hypre_tpu_torch.ops.csr import CSRMatrix
from hypre_tpu_torch.solvers import krylov as pk
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from torch_threads import one_thread  # noqa: F401

NX = 10
AMG = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
           relax_down=18, relax_up=18, embed_level1=False,
           relocate_level2=False, collapse_coarse_n=0)
# solver -> (options class name, options); the JAX package's names
SOLVERS = {
    "gmres": ("GMRESOptions", dict(k_dim=5)),
    "flexgmres": ("FlexGMRESOptions", dict(k_dim=5)),
    "lgmres": ("LGMRESOptions", dict(k_dim=10)),
    "cogmres": ("COGMRESOptions", dict(k_dim=5)),
    "cogmres_cgs2": ("COGMRESOptions", dict(k_dim=5, cgs=2)),
    "bicgstab": ("BiCGSTABOptions", dict()),
    "cgnr": ("CGNROptions", dict()),
}


@pytest.fixture(scope="module")
def problem():
    """The operator, its transpose, the diagonal and the two packages'
    AMG hierarchies, f64."""
    A = difconv_7pt(NX, NX, NX)
    As = A.to_scipy()
    jA = jax_difconv_7pt(NX, NX, NX)
    jamg = JaxBoomerAMG(jA, JaxOptions(dtype="float64", **AMG))
    amg = BoomerAMG(A, BoomerAMGOptions(dtype="float64", **AMG), device="cpu")
    AT = CSRMatrix.from_scipy(As.T.tocsr())
    return dict(A=A, AT=AT, dinv=1.0 / As.diagonal(), jamg=jamg, amg=amg,
                jE=jax_freeze_auto(jA),
                jET=jax_freeze_auto(jax_difconv_7pt(NX, NX, NX).__class__
                                    .from_scipy(As.T.tocsr())))


def run_both(problem, solver, precond, b, dtype="float64", port_only=False,
             **kw):
    """(port result, JAX result or None) of one solve."""
    cls, base = SOLVERS[solver]
    name = solver.split("_")[0]
    okw = {**base, **kw}
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    E = freeze_auto(problem["A"], tdt, "cpu")
    ET = freeze_auto(problem["AT"], tdt, "cpu")
    dinv_t = torch.from_numpy(problem["dinv"]).to(tdt)
    dinv_j = jnp.asarray(problem["dinv"], jdt)
    jE, jET = problem["jE"], problem["jET"]
    if dtype != "float64":
        jE = jax_freeze_auto(jax_difconv_7pt(NX, NX, NX), dtype=np.float32)
        jET = jax_freeze_auto(type(jax_difconv_7pt(1)).from_scipy(
            problem["A"].to_scipy().T.tocsr()), dtype=np.float32)
    M_t = {"amg": problem["amg"].precond, "diag": lambda r: dinv_t * r,
           "none": None}[precond]
    M_j = {"amg": problem["jamg"].precond, "diag": lambda r: dinv_j * r,
           "none": None}[precond]
    bt = torch.from_numpy(b).to(tdt)
    bj = jnp.asarray(b, jdt)
    pfun, jfun = getattr(pk, name), getattr(jk, name)
    popts, jopts = getattr(pk, cls)(**okw), getattr(jk, cls)(**okw)
    A_t = lambda x: spmv(E, x)  # noqa: E731
    A_j = lambda x: jax_spmv(jE, x)  # noqa: E731
    if name == "cgnr":
        res = pfun(A_t, lambda x: spmv(ET, x), bt, M=M_t, opts=popts)
        ref = None if port_only else jfun(
            A_j, lambda x: jax_spmv(jET, x), bj, M=M_j, opts=jopts)
    else:
        res = pfun(A_t, bt, M=M_t, opts=popts)
        ref = None if port_only else jfun(A_j, bj, M=M_j, opts=jopts)
    return res, ref


def assert_same(res, ref, tol):
    assert res.num_iterations == int(ref.num_iterations)
    assert res.converged == bool(ref.converged)
    h = res.res_norms.double().numpy()
    h_ref = np.asarray(ref.res_norms, np.float64)
    assert np.array_equal(np.isnan(h), np.isnan(h_ref))
    ok = ~np.isnan(h)
    scale = max(np.abs(h_ref[ok]).max(), 1e-300)
    assert np.abs(h[ok] - h_ref[ok]).max() <= tol * scale
    x, x_ref = res.x.double().numpy(), np.asarray(ref.x, np.float64)
    assert np.abs(x - x_ref).max() <= tol * max(np.abs(x_ref).max(), 1.0)
    rel, rel_ref = float(res.rel_residual_norm), float(ref.rel_residual_norm)
    assert abs(rel - rel_ref) <= tol * max(abs(rel_ref), 1.0)


def rhs(seed=3):
    return np.random.default_rng(seed).standard_normal(NX**3)


@pytest.mark.parametrize("precond", ["amg", "diag"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_solver_matches_jax(problem, solver, precond):
    max_iter = 50 if solver == "cgnr" else 200
    res, ref = run_both(problem, solver, precond, rhs(), tol=1e-8,
                        max_iter=max_iter)
    assert_same(res, ref, 1e-10)
    if solver != "cgnr":
        assert res.converged


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_zero_rhs_matches_jax(problem, solver):
    res, ref = run_both(problem, solver, "diag", np.zeros(NX**3), tol=1e-8)
    assert_same(res, ref, 1e-10)
    assert res.num_iterations == 0 and not res.x.any()


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_max_iter_matches_jax(problem, solver):
    """max_iter 7: ends mid-cycle for the restarted solvers."""
    res, ref = run_both(problem, solver, "diag", rhs(5), tol=1e-14,
                        max_iter=7)
    assert_same(res, ref, 1e-10)
    assert res.num_iterations == 7 and not res.converged


@pytest.mark.parametrize("solver", ["gmres", "flexgmres", "lgmres",
                                    "cogmres", "cogmres_cgs2"])
def test_breakdown_matches_jax(problem, solver):
    """A Krylov space of dimension one (b an eigenvector of a diagonal
    operator): the new basis vector is 0, its norm's guard keeps it 0,
    and both packages stop after one step with the exact solution."""
    d = np.linspace(1.0, 3.0, NX**3)
    b = np.zeros(NX**3)
    b[17] = 2.0
    cls, base = SOLVERS[solver]
    name = solver.split("_")[0]
    res = getattr(pk, name)(lambda x: torch.from_numpy(d) * x,
                            torch.from_numpy(b),
                            opts=getattr(pk, cls)(**base, tol=1e-12))
    ref = getattr(jk, name)(lambda x: jnp.asarray(d) * x, jnp.asarray(b),
                            opts=getattr(jk, cls)(**base, tol=1e-12))
    assert_same(res, ref, 1e-10)
    assert res.num_iterations == 1 and res.converged
    assert float(res.x[17]) == pytest.approx(2.0 / d[17], rel=1e-14)


@pytest.mark.parametrize("solver", ["gmres", "flexgmres", "lgmres",
                                    "cogmres"])
def test_stall_guard(problem, solver):
    """A cycle that takes no Arnoldi step ends the solve (the JAX
    package's guard `i_used == 0`, which only a cycle of k_dim 0 reaches;
    the JAX package cannot trace that shape): 0 iterations, unconverged,
    the history its first entry alone."""
    res, _ = run_both(problem, solver, "diag", rhs(), port_only=True,
                      tol=1e-8, k_dim=0)
    assert res.num_iterations == 0 and not res.converged
    h = res.res_norms.numpy()
    assert not np.isnan(h[0]) and np.isnan(h[1:]).all()
    assert float(res.rel_residual_norm) == pytest.approx(1.0, rel=1e-14)


@pytest.mark.parametrize("solver", ["gmres", "flexgmres", "lgmres",
                                    "cogmres_cgs2"])
def test_float32_matches_jax(problem, solver):
    """f32 vectors: the Hessenberg problem is solved in f32 on the host,
    as the JAX package solves it in the vectors' dtype: the same count,
    histories within 1e-4."""
    res, ref = run_both(problem, solver, "diag", rhs(), dtype="float32",
                        tol=1e-5, max_iter=200)
    assert res.x.dtype == torch.float32
    assert res.res_norms.dtype == torch.float32
    assert_same(res, ref, 1e-4)


def test_bicgstab_a_tol_and_cf_tol_match_jax(problem):
    for kw in (dict(tol=0.0, a_tol=1e-6), dict(tol=1e-12, cf_tol=0.3),
               dict(tol=1e-8, min_iter=4)):
        res, ref = run_both(problem, "bicgstab", "diag", rhs(), **kw)
        assert_same(res, ref, 1e-10)


@pytest.mark.parametrize("fn,args", [
    ("axpy", (0.7, "x", "y")), ("inner_prod", ("x", "y")), ("norm2", ("x",)),
    ("scale", (-1.5, "x")), ("set_constant", ("x", 2.5)),
    ("mass_inner_prod", ("x", "Y")), ("mass_axpy", ("a", "Y", "y")),
])
def test_blas1_matches_jax(fn, args):
    rng = np.random.default_rng(9)
    vals = {"x": rng.standard_normal(50), "y": rng.standard_normal(50),
            "Y": rng.standard_normal((4, 50)), "a": rng.standard_normal(4)}
    t_args = [torch.from_numpy(vals[a]) if isinstance(a, str) else a
              for a in args]
    j_args = [jnp.asarray(vals[a]) if isinstance(a, str) else a for a in args]
    got = np.asarray(getattr(blas1, fn)(*t_args))
    want = np.asarray(getattr(jax_blas1, fn)(*j_args))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
