"""AIR restriction (restrict_type 1 / 2, the Neumann variant) of the
port against the JAX package: a restriction R != P^T carried through
every solve-phase structure.

* The stationary solve on advection-dominated operators
  (tests/test_amg.py:346): the JAX package's counts and residual
  histories.
* The transposed hierarchy with R != P^T (interpolate with R^T,
  restrict with P^T): SolveT's count and history, one transpose cycle
  within 1e-12.
* The collapsed coarse sub-cycle built with the AIR R, and
  mult_additive, which smooths P and leaves an AIR R alone.
* The lattice forms: the JAX package's embedding builds level 0's R
  from P0^T and so drops the AIR R (pinned here); the port declines the
  embedding and the relocation under AIR, so its hierarchy with
  embed_level1=True is the one with embed_level1=False.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu_torch.models import difconv_7pt
from hypre_tpu_torch.ops import dia as port_dia
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from torch_threads import one_thread  # noqa: F401

PLAIN = dict(embed_level1=False, relocate_level2=False, collapse_coarse_n=0)
# the JAX package's AIR setting (tests/test_amg.py:364)
AIR = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
           relax_down=0, relax_up=0, relax_weight=0.7)
VARIANTS = {"air1": dict(restrict_type=1), "air2": dict(restrict_type=2),
            "neumann2": dict(restrict_type=2, air_neumann_degree=2)}


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def assert_solve_history(a, b):
    """Within 1e-10 relative while the residual is above 1e-4 of the
    first, and within 1e-14 of the first everywhere (a stationary
    solve's b - A x cancels as it converges)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    early = ok & (b >= 1e-4 * b[0])
    assert np.max(np.abs(a[early] - b[early]) / b[early]) <= 1e-10
    assert np.abs(a[ok] - b[ok]).max() <= 1e-14 * b[0]


def pair(shape, coeffs, kw):
    """(port, JAX) BoomerAMG on difconv_7pt(*shape, **coeffs)."""
    A = difconv_7pt(*shape, **coeffs)
    jA = jax_difconv_7pt(*shape, **coeffs)
    assert (A.to_scipy() != jA.to_scipy()).nnz == 0
    return (BoomerAMG(A, BoomerAMGOptions(**kw), device="cpu"),
            JaxBoomerAMG(jA, JaxOptions(**kw)), A)


ADVECTION = ((10, 10, 4), dict(ax=20.0, ay=10.0, az=0.0))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_air_solve_matches_jax(variant):
    """tests/test_amg.py:346 (CF-ordered weighted Jacobi): every level's
    R and A_c bitwise, the JAX package's count and history."""
    kw = dict(AIR, relax_order=1, **PLAIN, **VARIANTS[variant])
    amg, jamg, A = pair(*ADVECTION, kw)
    for k in range(len(jamg._host_A) - 1):
        assert same_csr(amg._host_R[k], jamg._host_R[k])
        assert same_csr(amg._host_A[k + 1], jamg._host_A[k + 1])
    b = A.to_scipy() @ np.ones(A.shape[0])
    res = amg.solve(torch.from_numpy(b), tol=1e-8, max_iter=80)
    ref = jamg.solve(jnp.asarray(b), tol=1e-8, max_iter=80)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert_solve_history(res.res_norms.numpy(), ref.res_norms)


def test_air_distance2_at_least_as_strong():
    iters = {}
    for variant in ("air1", "air2"):
        kw = dict(AIR, relax_order=1, **PLAIN, **VARIANTS[variant])
        A = difconv_7pt(*ADVECTION[0], **ADVECTION[1])
        amg = BoomerAMG(A, BoomerAMGOptions(**kw), device="cpu")
        b = torch.from_numpy(A.to_scipy() @ np.ones(A.shape[0]))
        iters[variant] = amg.solve(b, tol=1e-8, max_iter=80).num_iterations
    assert iters["air2"] <= iters["air1"] + 1


def test_frozen_R_is_the_air_restriction():
    """Every level's frozen R applies the AIR R, not P^T."""
    amg, _, _ = pair((8, 8, 8), dict(ax=6.0, ay=3.0, az=1.0),
                     dict(AIR, restrict_type=1, **PLAIN))
    rng = np.random.default_rng(0)
    for k, lvl in enumerate(amg.levels[:-1]):
        x = rng.standard_normal(lvl.dinv.shape[0])
        y = spmv(lvl.R, torch.from_numpy(x)).numpy()
        want = amg._host_R[k] @ x
        assert np.abs(y - want).max() <= 1e-13 * np.abs(want).max()
        assert np.abs(y - amg._host_P[k].T @ x).max() > 1e-3


@pytest.mark.parametrize("variant", ["air1", "air2"])
def test_solveT_with_air(variant):
    """The transposed hierarchy interpolates with R^T and restricts
    with P^T: SolveT takes the JAX package's count and history, one
    transpose cycle agrees within 1e-12."""
    amg, jamg, A = pair((8, 8, 8), dict(ax=6.0, ay=3.0, az=1.0),
                        dict(AIR, **PLAIN, **VARIANTS[variant]))
    xt = np.random.default_rng(3).standard_normal(A.shape[0])
    bt = A.to_scipy().T @ xt
    res = amg.solveT(torch.from_numpy(bt), tol=1e-9, max_iter=80)
    ref = jamg.solveT(jnp.asarray(bt), tol=1e-9, max_iter=80)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert_solve_history(res.res_norms.numpy(), ref.res_norms)
    np.testing.assert_allclose(res.x.numpy(), xt, atol=1e-6)
    v = np.random.default_rng(5).standard_normal(A.shape[0])
    z = amg.cycleT(torch.from_numpy(v)).numpy()
    zr = np.asarray(jamg.cycleT(jnp.asarray(v)))
    assert np.abs(z - zr).max() / np.abs(zr).max() <= 1e-12
    lvl = amg.levels_T[0]
    x = np.random.default_rng(7).standard_normal(amg._host_R[0].shape[0])
    y = spmv(lvl.P, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, amg._host_R[0].T @ x, rtol=0, atol=1e-13)


def test_collapse_with_air():
    """The collapsed coarse sub-cycle is built with each level's AIR R:
    one cycle equals the JAX package's within 1e-12 and the uncollapsed
    hierarchy's within 1e-12 (exact linear algebra)."""
    shape, coeffs = (12, 12, 12), dict(ax=6.0, ay=3.0, az=1.0)
    kw = dict(AIR, restrict_type=1, embed_level1=False,
              relocate_level2=False, collapse_coarse_n=2048)
    amg, jamg, A = pair(shape, coeffs, kw)
    assert amg.num_frozen_levels < amg.num_levels
    assert amg.num_frozen_levels == len(jamg.levels)
    full = BoomerAMG(A, BoomerAMGOptions(**dict(kw, collapse_coarse_n=0)),
                     device="cpu")
    assert full.num_frozen_levels == full.num_levels
    v = np.random.default_rng(1).standard_normal(A.shape[0])
    z = amg.cycle(torch.from_numpy(v)).numpy()
    zr = np.asarray(jamg.cycle(jnp.asarray(v)))
    zf = full.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - zr).max() / np.abs(zr).max() <= 1e-12
    assert np.abs(z - zf).max() / np.abs(zf).max() <= 1e-12


def test_mult_additive_leaves_the_air_restriction():
    """mult_additive smooths P (C^ns P) and leaves an AIR R as it was,
    as the JAX package does; one additive cycle agrees within 1e-12."""
    shape, coeffs = (8, 8, 8), dict(ax=6.0, ay=3.0, az=1.0)
    kw = dict(AIR, restrict_type=1, relax_down=18, relax_up=18, **PLAIN)
    plain, _, _ = pair(shape, coeffs, kw)
    amg, jamg, A = pair(shape, coeffs, dict(kw, mult_additive=0))
    for k in range(len(amg._host_R)):
        assert same_csr(amg._host_R[k], plain._host_R[k])
        assert same_csr(amg._host_R[k], jamg._host_R[k])
        assert same_csr(amg._host_P[k], jamg._host_P[k])
    assert abs(amg._host_P[0] - plain._host_P[0]).max() > 1e-3
    v = np.random.default_rng(2).standard_normal(A.shape[0])
    z = amg.cycle(torch.from_numpy(v)).numpy()
    zr = np.asarray(jamg.cycle(jnp.asarray(v)))
    assert np.abs(z - zr).max() / np.abs(zr).max() <= 1e-12


def test_cycle_launches_with_air(monkeypatch):
    """`cycle_launches` counts an AIR hierarchy's restrictions (ELL)."""
    counts = {"dia_spmv": 0, "ell_spmv": 0}
    for attr in counts:
        fn = getattr(port_dia, attr)

        def counted(*a, _fn=fn, _key=attr, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(port_dia, attr, counted)
    A = difconv_7pt(20, 20, 20, ax=6.0, ay=3.0, az=1.0)
    amg = BoomerAMG(A, BoomerAMGOptions(**dict(AIR, restrict_type=2, **PLAIN)),
                    device="cpu")
    want = {k: v for k, v in amg.cycle_launches().items() if v}
    amg.cycle(torch.ones(A.shape[0], dtype=torch.float64))
    assert {k: v for k, v in counts.items() if v} == want


# -- the deviation: AIR on the lattice forms --------------------------------

DEVIATION = ((20, 20, 20), dict(ax=6.0, ay=3.0, az=1.0))


@pytest.mark.parametrize("device_rap", [False, True])
def test_jax_embedding_replaces_air_R_with_P_transpose(device_rap):
    """The JAX package's behaviour, pinned, not copied: with the
    level-1 embedding on (its default) under restrict_type=1, its
    embedded level-0 R applies P0^T exactly and differs from the AIR
    R0 (by 5.19 on this input)."""
    A = jax_difconv_7pt(*DEVIATION[0], **DEVIATION[1])
    jamg = JaxBoomerAMG(A, JaxOptions(**AIR, restrict_type=1,
                                      device_rap=device_rap))
    lv = unview(list(jamg.levels))
    n0 = A.num_rows
    assert lv[1].dinv.shape[0] == n0  # embedded
    cpos0 = np.flatnonzero(jamg._cf[0] > 0)
    x = np.random.default_rng(0).standard_normal(n0)
    y = np.asarray(jax_spmv(lv[0].R, jnp.asarray(x)))
    assert np.array_equal(y[cpos0], jamg._host_P[0].T @ x)
    assert np.abs(np.delete(y, cpos0)).max() == 0.0
    assert np.abs(y[cpos0] - jamg._host_R[0] @ x).max() > 1.0


@pytest.mark.parametrize("extra", [dict(), dict(lattice_shape=(20, 20, 20),
                                                relocate_min_n2=0)],
                         ids=["embed", "embed+relocate"])
def test_port_declines_the_lattice_forms_under_air(extra):
    """The port's AIR hierarchy with embed_level1=True (and the
    relocation asked for) is its hierarchy with embed_level1=False:
    the same forms and the same bits of one cycle and of each level's
    R applied."""
    A = difconv_7pt(*DEVIATION[0], **DEVIATION[1])
    base = dict(AIR, restrict_type=1, collapse_coarse_n=0, **extra)
    lat = BoomerAMG(A, BoomerAMGOptions(**base), device="cpu")
    plain = BoomerAMG(A, BoomerAMGOptions(**dict(
        base, embed_level1=False, relocate_level2=False)), device="cpu")
    assert lat._plan_embed() is None and not lat._reloc_cells
    assert len(lat.levels) == len(plain.levels)
    rng = np.random.default_rng(4)
    for k, (a, b) in enumerate(zip(lat.levels, plain.levels)):
        assert type(a.A) is type(b.A) and a.dinv.shape == b.dinv.shape
        if b.R is None:
            continue
        x = torch.from_numpy(rng.standard_normal(b.dinv.shape[0]))
        assert torch.equal(spmv(a.R, x), spmv(b.R, x))
        want = lat._host_R[k] @ x.numpy()
        assert np.abs(spmv(a.R, x).numpy() - want).max() <= 1e-13 * np.abs(
            want).max()
    v = torch.from_numpy(rng.standard_normal(A.shape[0]))
    assert torch.equal(lat.cycle(v), plain.cycle(v))
