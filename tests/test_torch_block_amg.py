"""Block AMG (hypre_tpu_torch/solvers/amg/block_amg.py) on the CPU
against the JAX package's: bsr_to_block_ell bitwise, block_spmv within
1e-12 of the scalar product and of the JAX package's, every level's
host block operator, nodal CF and block P (direct, classical,
classical_diag) bitwise, one V-cycle within 1e-12, and the stationary
and PCG solves of tests/test_block_amg.py with the same count and
history."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hypre_tpu.models as jm
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers import krylov as jk
from hypre_tpu.solvers.amg import block_amg as jblock
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.ops.dia import freeze_auto, spmv
from hypre_tpu_torch.solvers.amg import block_amg
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_family import chip_smoke, host, rel, same_solve
from torch_threads import one_thread  # noqa: F401

INTERPS = ["direct", "classical", "classical_diag"]


def _same_bsr(a, b):
    return (a.shape == b.shape and a.blocksize == b.blocksize
            and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def test_block_ell_and_block_spmv_match():
    As = pm.sys_laplacian_7pt(8, 8, 8, 2).to_scipy().tocsr()
    n = As.shape[0]
    B = block_amg.bsr_to_block_ell(As.tobsr(blocksize=(2, 2)), device="cpu")
    Bj = jblock.bsr_to_block_ell(As.tobsr(blocksize=(2, 2)))
    assert np.array_equal(host(B.cols), host(Bj.cols))
    assert np.array_equal(host(B.data), host(Bj.data))
    assert (B.num_brows, B.num_bcols, B.nb) == (Bj.num_brows, Bj.num_bcols, 2)
    x = np.random.default_rng(0).standard_normal(n)
    y = block_amg.block_spmv(B, torch.from_numpy(x.reshape(-1, 2)))
    assert rel(y[: n // 2].reshape(-1), As @ x) <= 1e-12
    assert rel(y, jblock.block_spmv(Bj, jnp.asarray(x.reshape(-1, 2)))) <= 1e-12


@pytest.fixture(scope="module")
def problem():
    return pm.sys_laplacian_7pt(8, 8, 8, 2), jm.sys_laplacian_7pt(8, 8, 8, 2)


@pytest.fixture(scope="module", params=INTERPS)
def pair(request, problem):
    """(A, Aj, the port's BlockAMG, the JAX package's) at 8^3 x 2."""
    A, Aj = problem
    interp = request.param
    return (A, Aj,
            block_amg.BlockAMG(A, block_amg.BlockAMGOptions(
                interp_type=interp), device="cpu"),
            jblock.BlockAMG(Aj, jblock.BlockAMGOptions(interp_type=interp)))


def test_block_hierarchy_matches_jax(pair):
    """Every level's host block operator, block diagonal inverses and
    block P / R bitwise (>= 3 levels, each block-valued), one V-cycle
    within 1e-12."""
    A, _, amg, jamg = pair
    assert len(amg.levels) == len(jamg.levels) >= 3
    for lv, jlv in zip(amg.levels, jamg.levels):
        assert _same_bsr(lv.Ah, jlv.Ah) and lv.A.data.dim() == 4
        assert np.array_equal(host(lv.dinv), host(jlv.dinv))
        assert (lv.P is None) == (jlv.P is None)
        if lv.P is not None:
            assert np.array_equal(host(lv.P.data), host(jlv.P.data))
            assert np.array_equal(host(lv.P.cols), host(jlv.P.cols))
            assert np.array_equal(host(lv.R.data), host(jlv.R.data))
        else:
            assert np.array_equal(host(lv.coarse_inv), host(jlv.coarse_inv))
    r = np.random.default_rng(1).standard_normal(A.num_rows)
    assert rel(amg.cycle(torch.from_numpy(r)), jamg.cycle(jnp.asarray(r))) \
        <= 1e-12


def test_block_solves_match_jax(pair):
    """tests/test_block_amg.py: the stationary solve (b = A 1, tol 1e-8)
    and PCG (b = ones, tol 1e-9) with the same counts and histories, x
    within 1e-10."""
    A, Aj, amg, jamg = pair
    b = A.to_scipy() @ np.ones(A.num_rows)
    res = amg.solve(torch.from_numpy(b), tol=1e-8, max_iter=100)
    assert res.converged
    same_solve(res, jamg.solve(jnp.asarray(b), tol=1e-8, max_iter=100))
    E, Ej = freeze_auto(A, torch.float64, "cpu"), jax_freeze_auto(Aj)
    ones = np.ones(A.num_rows)
    res = pcg(lambda x: spmv(E, x), torch.from_numpy(ones), M=amg.precond,
              opts=PCGOptions(tol=1e-9, max_iter=100))
    jres = jk.pcg(lambda x: jax_spmv(Ej, x), jnp.asarray(ones),
                  M=jamg.precond, opts=jk.PCGOptions(tol=1e-9, max_iter=100))
    assert res.converged and same_solve(res, jres) <= 15


def test_block_direct_interp_blows_up_in_both_packages():
    """An open fault of both packages (ROADMAP Queue 3): the block direct
    interpolation's row-sum scale S_i = (sum_C A_ij)^{-1} (sum A_ij)
    solves with near-singular block sums unguarded, so at 10^3 x 2 the
    level-1 P holds entries ~4e15 and a coarse operator ~2e32 (bitwise
    the same in both packages); the V-cycle then amplifies rounding
    (at 12^3 a 1e-15 change of r moves it by ~3e-6), and at 48^3 PCG
    breaks down (the slow test below)."""
    A, Aj = pm.sys_laplacian_7pt(10, 10, 10, 2), jm.sys_laplacian_7pt(
        10, 10, 10, 2)
    amg = block_amg.BlockAMG(A, block_amg.BlockAMGOptions(), device="cpu")
    jamg = jblock.BlockAMG(Aj, jblock.BlockAMGOptions())
    for m in (amg, jamg):
        assert max(float(np.abs(host(l.P.data)).max())
                   for l in m.levels[:-1]) > 1e15
        assert max(float(np.abs(host(l.A.data)).max()) for l in m.levels) > 1e30
    for lv, jlv in zip(amg.levels, jamg.levels):
        assert _same_bsr(lv.Ah, jlv.Ah)


@pytest.mark.slow
@pytest.mark.parametrize("interp", ["direct", "classical"])
def test_jax_count_at_24_is_the_chip_pin(interp):
    """The JAX package's BlockAMG-PCG count on sys_laplacian_7pt(24^3,
    2) (b = ones, tol 1e-8): chip_smoke.py phase 16 (h)."""
    Aj = jm.sys_laplacian_7pt(24, 24, 24, 2)
    jamg = jblock.BlockAMG(Aj, jblock.BlockAMGOptions(interp_type=interp))
    Ej = jax_freeze_auto(Aj)
    jres = jk.pcg(lambda x: jax_spmv(Ej, x), jnp.ones(Aj.num_rows),
                  M=jamg.precond, opts=jk.PCGOptions(tol=1e-8, max_iter=100))
    assert bool(jres.converged)
    assert int(jres.num_iterations) == chip_smoke().AUX_BLOCK24[interp]


@pytest.mark.slow
@pytest.mark.parametrize("interp", ["direct", "classical"])
def test_block_amg_breaks_down_at_48_in_both_packages(interp):
    """An open fault of both packages (ROADMAP Queue 3): at 48^3 x 2 the
    block V-cycle is no SPD preconditioner, so PCG meets a negative
    <r, M r>, which its convergence test (the ratio to <M b, b> below
    tol^2) takes for convergence, and stops with a NaN residual norm
    after a few iterations in both packages (direct: 7 and 7; classical:
    4 in the port, 2 in the JAX package, the rounding the cycle
    magnifies differing), hence phase 16 (h) at 24^3 (~1 min each)."""
    A, Aj = pm.sys_laplacian_7pt(48, 48, 48, 2), jm.sys_laplacian_7pt(
        48, 48, 48, 2)
    amg = block_amg.BlockAMG(A, block_amg.BlockAMGOptions(interp_type=interp),
                             device="cpu")
    res = pcg(lambda x: spmv(freeze_auto(A, torch.float64, "cpu"), x),
              torch.ones(A.num_rows, dtype=torch.float64), M=amg.precond,
              opts=PCGOptions(tol=1e-8, max_iter=100))
    jamg = jblock.BlockAMG(Aj, jblock.BlockAMGOptions(interp_type=interp))
    Ej = jax_freeze_auto(Aj)
    jres = jk.pcg(lambda x: jax_spmv(Ej, x), jnp.ones(Aj.num_rows),
                  M=jamg.precond, opts=jk.PCGOptions(tol=1e-8, max_iter=100))
    for its, r in ((res.num_iterations, res),
                   (int(jres.num_iterations), jres)):
        assert np.isnan(float(r.rel_residual_norm)) and its < 10
