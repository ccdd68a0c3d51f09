"""MGR (hypre_tpu_torch/solvers/amg/mgr.py) on the CPU against the JAX
package's: block_diag_inv and nsh_approx_inverse bitwise, W_p, W_r and
the coarse operator for every interpolation / restriction kind bitwise,
the coarse BoomerAMG the same hierarchy, one application within 1e-12,
and the FlexGMRES solves of tests/test_mgr_schwarz.py with the same
count and history.  Injection's W_p is all zero; frozen as ELL it has
width 1 and its matvec gives zeros (on the card too:
tests/test_torch_cuda.py::test_mgr_injection_wp_gives_zeros_on_card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hypre_tpu.models as jm
from hypre_tpu.solvers.amg import mgr as jmgr
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.ops.csr import ELLMatrix
from hypre_tpu_torch.ops.dia import spmv
from hypre_tpu_torch.solvers.amg import mgr
from torch_family import (chip_smoke, host, rel, same_csr, same_dense,
                          same_hierarchy, same_solve)
from torch_threads import one_thread  # noqa: F401


def _case(kind, nx, opts, split=2):
    port, jax_ = getattr(pm, kind), getattr(jm, kind)
    args = (nx, nx) if kind == "laplacian_5pt_2d" else (nx, nx, nx, 2)
    A, Aj = port(*args), jax_(*args)
    cm = np.arange(A.num_rows) % split == (1 if kind.startswith("sys") else 0)
    return (A, Aj, mgr.MGR(A, cm, mgr.MGROptions(**opts), device="cpu"),
            jmgr.MGR(Aj, cm, jmgr.MGROptions(**opts)))


def test_block_diag_inv_and_nsh_are_the_jax_packages():
    A = pm.laplacian_5pt_2d(7, 7).to_scipy().tocsr()  # 49 rows: a 1x1 tail
    for blk in (2, 3):
        assert same_csr(mgr.block_diag_inv(A, blk), jmgr.block_diag_inv(A, blk))
    for kw in ({}, dict(droptol=1e-3, max_row_nnz=8)):
        assert same_csr(mgr.nsh_approx_inverse(A, **kw),
                        jmgr.nsh_approx_inverse(A, **kw))


def test_block_diag_inv_makes_no_dense_copy(monkeypatch):
    """A Queue 3 deviation: the JAX package's block_diag_inv reads the
    blocks from a dense copy of A's leading nb*blk square (n^2 values:
    91 GiB for phase 16 (c)'s 110,592-row A_ff); the port reads them
    from A's entries, the same result bit for bit."""
    A = pm.sys_laplacian_7pt(10, 10, 10, 2).to_scipy().tocsr()
    dense = []
    real = sp.csr_matrix.toarray

    def toarray(self, *args, **kw):
        dense.append(self.shape)
        return real(self, *args, **kw)

    monkeypatch.setattr(sp.csr_matrix, "toarray", toarray)
    ref = jmgr.block_diag_inv(A, 2)
    assert dense == [(2000, 2000)]
    dense.clear()
    assert same_csr(mgr.block_diag_inv(A, 2), ref) and dense == []


@pytest.mark.parametrize("interp,restrict", [
    ("injection", "injection"), ("jacobi", "jacobi"),
    ("blk_jacobi", "blk_jacobi"), ("approx_inv", "injection"),
    ("classical", "jacobi")])
def test_transfers_and_coarse_operator_are_the_jax_packages(interp, restrict):
    """laplacian_5pt_2d(10, 10) with every third unknown C and the
    Galerkin coarse grid: W_p, W_r (frozen dense) and the coarse A
    bitwise, the coarse BoomerAMG the same hierarchy; one application
    within 1e-12."""
    opts = dict(interp_type=interp, restrict_type=restrict, blk_size=2,
                coarse_grid_method="galerkin")
    A, _, m, jm_ = _case("laplacian_5pt_2d", 10, opts, split=3)
    lv, jlv = m.levels[0], jm_.levels[0]
    assert same_dense(lv["Wp"], jlv["Wp"])
    assert (lv["Wr"] is None) == (jlv["Wr"] is None)
    if lv["Wr"] is not None:
        assert same_dense(lv["Wr"], jlv["Wr"])
    assert same_csr(m.host_Ac[0], jm_.amg._host_A[0])
    assert same_hierarchy(m.amg, jm_.amg)
    r = np.random.default_rng(7).standard_normal(A.num_rows)
    assert rel(m.precond(torch.from_numpy(r)),
               jm_.precond(jnp.asarray(r))) <= 1e-12


SOLVES = {
    "default": ("laplacian_5pt_2d", 8, dict()),
    "blk_jacobi + blk F-relax": ("laplacian_5pt_2d", 8, dict(
        interp_type="blk_jacobi", frelax="blk_jacobi", blk_size=2,
        num_f_sweeps=2)),
    "approx_inv": ("laplacian_5pt_2d", 8, dict(interp_type="approx_inv")),
    "classical": ("laplacian_5pt_2d", 8, dict(interp_type="classical")),
    "amg F-relax": ("laplacian_5pt_2d", 8, dict(frelax="amg")),
    "jacobi F-relax x3": ("laplacian_5pt_2d", 8, dict(num_f_sweeps=3)),
    # phase 16 (c)'s second option line at 6^3 x 2
    "sys blk / amg / galerkin": ("sys_laplacian_7pt", 6, dict(
        interp_type="blk_jacobi", restrict_type="blk_jacobi", frelax="amg",
        blk_size=2, coarse_grid_method="galerkin")),
}


@pytest.mark.parametrize("label", sorted(SOLVES))
def test_mgr_flexgmres_matches_jax(label):
    """MGR.solve (FlexGMRES(10), b = ones, tol 1e-9; tests/test_mgr_schwarz.py's
    cases at 8 x 8): the same count and history, x within 1e-10; the
    F-relaxation AMG the same hierarchy."""
    kind, nx, opts = SOLVES[label]
    A, Aj, m, jm_ = _case(kind, nx, opts)
    if m.levels[0]["famg"] is not None:
        assert same_hierarchy(m.levels[0]["famg"], jm_.levels[0]["famg"])
    b = np.ones(A.num_rows)
    res = m.solve(A, torch.from_numpy(b), tol=1e-9)
    assert res.converged
    same_solve(res, jm_.solve(Aj, jnp.asarray(b), tol=1e-9))


def test_mgr_multilevel_matches_jax():
    """tests/test_mgr_schwarz.py's two reduction levels."""
    A, Aj = pm.laplacian_7pt(8, 8, 4), jm.laplacian_7pt(8, 8, 4)
    cm0 = np.arange(A.num_rows) % 2 == 0
    cm1 = np.arange(int(cm0.sum())) % 2 == 0
    m = mgr.MGR(A, [cm0, cm1], device="cpu")
    jm_ = jmgr.MGR(Aj, [cm0, cm1])
    b = np.ones(A.num_rows)
    res = m.solve(A, torch.from_numpy(b), tol=1e-8)
    assert res.converged and len(m.levels) == 2
    same_solve(res, jm_.solve(Aj, jnp.asarray(b), tol=1e-8))


def _injection_wp(device):
    """sys_laplacian_7pt(20, 20, 20, 2) with function 1 C: injection's
    W_p is the all-zero 8000 x 8000 block, past the dense threshold."""
    A = pm.sys_laplacian_7pt(20, 20, 20, 2)
    cm = np.arange(A.num_rows) % 2 == 1
    return A, cm, mgr.MGR(A, cm, mgr.MGROptions(interp_type="injection"),
                          device=device)


def test_injection_wp_is_a_zero_ell_of_width_one():
    """(Injection's application against the JAX package's is held with
    the other kinds above, at a size where W_p is dense.)"""
    _, _, m = _injection_wp("cpu")
    Wp = m.levels[0]["Wp"]
    assert isinstance(Wp, ELLMatrix) and Wp.nnz == 0
    assert tuple(Wp.cols.shape) == (1, 8000)
    assert not bool(Wp.row_len.any())
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(8000))
    assert torch.equal(spmv(Wp, x), torch.zeros(8000, dtype=torch.float64))


@pytest.mark.slow
@pytest.mark.parametrize("label", ["default", "blk_jacobi"])
def test_jax_count_at_48_is_the_chip_pin(label, monkeypatch):
    """The JAX package's MGR-FlexGMRES counts on sys_laplacian_7pt(48^3,
    2) with function 1 C (tol 1e-8, b = ones): chip_smoke.py phase 16 (c)
    (~2 min each).  The blk_jacobi line runs the JAX package with the
    port's block_diag_inv (the same blocks bit for bit; the JAX
    package's own needs 91 GiB here)."""
    opts, want = chip_smoke().AUX_MGR48[label]
    if label == "blk_jacobi":
        monkeypatch.setattr(jmgr, "block_diag_inv", mgr.block_diag_inv)
    Aj = jm.sys_laplacian_7pt(48, 48, 48, 2)
    cm = np.arange(Aj.num_rows) % 2 == 1
    jres = jmgr.MGR(Aj, cm, jmgr.MGROptions(**opts)).solve(
        Aj, jnp.ones(Aj.num_rows), tol=1e-8)
    assert int(jres.num_iterations) == want
