"""PILUT (hypre_tpu_torch/solvers/amg/pilut.py) on the CPU against the
JAX package's: partial_ilut's L, U and S bitwise, the stages (the
permutations and the frozen couplings) bitwise, one application within
1e-12, and the GMRES solves of tests/test_pilut.py with the same count
and history."""

import jax.numpy as jnp
import numpy as np
import numpy.linalg as la
import pytest
import torch

import hypre_tpu.models as jm
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers import krylov as jk
from hypre_tpu.solvers.amg import pilut as jpilut
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.ops.dia import freeze_auto, spmv
from hypre_tpu_torch.solvers.amg import pilut
from hypre_tpu_torch.solvers.krylov import GMRESOptions, gmres
from torch_family import chip_smoke, host, rel, same_csr, same_dense, same_solve
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("kind", ["laplacian", "difconv"])
@pytest.mark.parametrize("ni,droptol,lfil", [
    (150, 0.0, 10**9), (150, 1e-3, 30), (100, 0.05, 5)])
def test_partial_ilut_is_the_jax_packages(kind, ni, droptol, lfil):
    A = getattr(pm, f"{kind}_7pt")(6, 6, 6).to_scipy().tocsr()
    got = pilut.partial_ilut(A, ni, droptol, lfil)
    ref = jpilut.partial_ilut(A, ni, droptol, lfil)
    for g, r in zip(got, ref):
        assert same_csr(g, r)


def test_partial_ilut_exact_schur():
    """droptol=0, unlimited fill: S == C - E B^{-1} F to roundoff, L
    strictly lower with columns below ni, U upper (tests/test_pilut.py)."""
    A = pm.laplacian_7pt(6, 6, 6).to_scipy().tocsr()
    ni = 150
    L, U, S = pilut.partial_ilut(A, ni, droptol=0.0, lfil=10**9)
    Ad = A.toarray()
    B, F = Ad[:ni, :ni], Ad[:ni, ni:]
    E, C = Ad[ni:, :ni], Ad[ni:, ni:]
    assert np.abs(S.toarray() - (C - E @ la.solve(B, F))).max() < 1e-12
    assert (L.diagonal() == 0).all()
    Lc, Uc = L.tocoo(), U.tocoo()
    assert (Lc.col < np.minimum(Lc.row, ni)).all() and (Uc.col >= Uc.row).all()


def _pair(nx, **kw):
    A, Aj = pm.laplacian_7pt(nx, nx, nx), jm.laplacian_7pt(nx, nx, nx)
    return (A, Aj, pilut.PILUT(A, pilut.PILUTOptions(**kw), device="cpu"),
            jpilut.PILUT(Aj, jpilut.PILUTOptions(**kw)))


def test_pilut_stages_and_application_match_jax():
    """10^3: the same stages (>= 2), each stage's permutation, sizes and
    frozen couplings bitwise, the tail ILUT's schedules the same shape, and
    one application within 1e-12."""
    A, _, p, jp = _pair(10)
    assert len(p.stages) == len(jp.stages) >= 2
    for st, jst in zip(p.stages, jp.stages):
        assert np.array_equal(host(st["perm"]), host(jst["perm"]))
        assert np.array_equal(host(st["iperm"]), host(jst["iperm"]))
        assert (st["ni"], st["n"]) == (jst["ni"], jst["n"])
        assert st["Ls"].num_wavefronts == jst["Ls"].rows.shape[0]
        assert st["Us"].num_wavefronts == jst["Us"].rows.shape[0]
        assert same_dense(st["L_EB"], jst["L_EB"])
        assert same_dense(st["U_BF"], jst["U_BF"])
    for S, jS in ((p._tail._Lsched, jp._tail._Lsched),
                  (p._tail._Usched, jp._tail._Usched)):
        assert (S.n, S.num_wavefronts) == (jS.n, jS.rows.shape[0])
    r = np.random.default_rng(3).standard_normal(A.num_rows)
    assert rel(p.solve(torch.from_numpy(r)), jp.solve(jnp.asarray(r))) <= 1e-12
    assert p.apply_launches() == {"gs_sweep": 2 * len(p.stages) + 2}


def _gmres(A, M, b, tol, max_iter):
    E = freeze_auto(A, torch.float64, "cpu")
    return gmres(lambda x: spmv(E, x), torch.from_numpy(b), M=M,
                 opts=GMRESOptions(tol=tol, max_iter=max_iter, k_dim=30))


def _jax_gmres(Aj, M, b, tol, max_iter):
    Ej = jax_freeze_auto(Aj)
    return jk.gmres(lambda x: jax_spmv(Ej, x), jnp.asarray(b), M=M,
                    opts=jk.GMRESOptions(tol=tol, max_iter=max_iter, k_dim=30))


@pytest.mark.parametrize("nx,kw", [
    (10, dict(num_domains=4, droptol=1e-3, lfil=30)),
    (8, dict(droptol=5e-2, lfil=5)),
])
def test_pilut_gmres_matches_jax(nx, kw):
    """tests/test_pilut.py's solves (b = A 1, GMRES(30), tol 1e-8): the
    same count and history, x within 1e-10."""
    A, Aj, p, jp = _pair(nx, **kw)
    b = A.to_scipy() @ np.ones(A.num_rows)
    res = _gmres(A, p.precond, b, 1e-8, 150)
    assert res.converged
    same_solve(res, _jax_gmres(Aj, jp.precond, b, 1e-8, 150))


@pytest.mark.slow
def test_jax_count_at_48_is_the_chip_pin():
    """The JAX package's PILUT-GMRES(30) count at 48^3 (tol 1e-8, b =
    ones; ~1 min, partial_ilut's row loop): chip_smoke.py phase 16 (b)."""
    Aj = jm.laplacian_7pt(48, 48, 48)
    jp = jpilut.PILUT(Aj, jpilut.PILUTOptions())
    jres = _jax_gmres(Aj, jp.precond, np.ones(Aj.num_rows), 1e-8, 200)
    assert bool(jres.converged)
    want_its, want_stages = chip_smoke().AUX_PILUT48
    assert (int(jres.num_iterations), len(jp.stages)) == (want_its, want_stages)
