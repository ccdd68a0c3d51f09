"""The port's struct solvers (hypre_tpu_torch/solvers/struct_ls/) against
the JAX package's, piece by piece, in f64 on the CPU.

Tolerances:
  * host setup bitwise: PFMG's levels (cdir, active, weight, each
    level's operator, inverse diagonal, interpolation weights p_lo /
    p_hi, the red mask), SMG's dense plane inverses and the 2-D SMG's
    levels, SparseMSG's grids, transfers, visit weights and inverse
    diagonals;
  * SMG's interpolation weights come from plane solves on the device
    (a batched product, or six 2-D V-cycles), so they and the coarse
    operators built from them are held within 1e-12 of the largest
    entry, not bitwise;
  * device ops within 1e-12 of the largest entry: one PFMG cycle per
    relax type, the semicoarsening transfers (nf even and odd), one SMG
    cycle (dense and recursive planes), one SparseMSG cycle, the
    smoothers, PCR;
  * solvers: the same count, the residual history within 1e-10 of its
    largest entry.
The JAX pieces run eagerly; the two JAX solves (PFMG, StructJacobi) are
the file's only `while_loop` compiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import hypre_tpu.solvers.struct_ls.smg as jsmg
import hypre_tpu_torch.solvers.struct_ls.smg as tsmg
from hypre_tpu.solvers import struct_ls as jls
from hypre_tpu.solvers.struct_ls.cyclic_reduction import (
    CyclicReduction as JaxCR, pcr_solve_batched as jax_pcr)
from hypre_tpu.struct import StructGrid as JaxGrid
from hypre_tpu.struct import StructMatrix as JaxStructMatrix
from hypre_tpu_torch.solvers import struct_ls as tls
from hypre_tpu_torch.solvers.struct_ls.cyclic_reduction import (
    CyclicReduction, pcr_solve_batched)
from hypre_tpu_torch.struct import StructGrid, StructMatrix
from torch_threads import one_thread  # noqa: F401

TOL = 1e-12


def stencil(shape, c=(1.0, 1.0, 1.0), var=0.0, seed=0):
    """The 5- / 7-point stencil with coefficients c, each entry scaled
    by 1 + var * U[0, 1) (var > 0: a variable-coefficient operator)."""
    rng = np.random.default_rng(seed)
    nd = len(shape)

    def jitter():
        return 1.0 + var * rng.random(shape)

    e = {(0,) * nd: 2 * sum(c[:nd]) * jitter()}
    for d in range(nd):
        for s in (-1, 1):
            o = [0] * nd
            o[d] = s
            e[tuple(o)] = -c[d] * jitter()
    return e


def both(entries, shape, periodic=None):
    return (StructMatrix.from_dict(entries, StructGrid(shape, periodic),
                                   device="cpu"),
            JaxStructMatrix.from_dict(entries, JaxGrid(shape, periodic)))


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


def t(a):
    return torch.from_numpy(np.asarray(a))


def in_box(jA):
    """The JAX matrix's data with the taps that leave the box (along the
    non-periodic axes) zeroed: the same operator, as a solver's frozen
    level holds it (`StructMatrix.boxed`)."""
    data = np.array(jA.data)
    shape = data.shape[1:]
    idx = np.indices(shape)
    for k, off in enumerate(jA.offsets):
        ok = np.ones(shape, bool)
        for d, (o, p) in enumerate(zip(off, jA.periodic or (0,) * len(shape))):
            if not p:
                ok &= (idx[d] + o >= 0) & (idx[d] + o < shape[d])
        data[k] = np.where(ok, data[k], 0.0)
    return data


def same_matrix(A, jA):
    """A frozen level's matrix: the JAX level's operator bitwise, its
    out-of-box taps zeroed."""
    assert A.offsets == jA.offsets and tuple(A.shape) == tuple(jA.shape)
    assert A.in_box and np.array_equal(A.data.numpy(), in_box(jA))


# -- PFMG --------------------------------------------------------------------

PFMG_CASES = {
    "aniso 12^3 skip 0": ((12, 12, 12), dict(c=(2.0, 3.0, 40.0)),
                          dict(skip_relax=0)),
    "variable 9x8x7 skip 1": ((9, 8, 7), dict(var=0.5), dict(skip_relax=1)),
    "2-D 12x11 rb": ((12, 11), dict(c=(1.0, 5.0)), dict(relax_type=2)),
    "periodic 8x6x5": ((8, 6, 5), dict(c=(1.0, 2.0, 0.5)), dict()),
}


def pfmg_pair(case):
    shape, kw, okw = PFMG_CASES[case]
    per = (8, 0, 0) if case.startswith("periodic") else None
    A, jA = both(stencil(shape, **kw), shape, per)
    return (tls.PFMG(A, tls.PFMGOptions(**okw)),
            jls.PFMG(jA, jls.PFMGOptions(**okw)))


@pytest.mark.parametrize("case", sorted(PFMG_CASES))
def test_pfmg_hierarchy_bitwise(case):
    p, j = pfmg_pair(case)
    assert p.num_levels == j.num_levels > 1
    for lt, lj in zip(p.levels, j.levels):
        assert (lt.cdir, lt.active, lt.weight) == (lj.cdir, lj.active, lj.weight)
        same_matrix(lt.A, lj.A)
        assert lt.A.periodic == lj.A.periodic
        assert np.array_equal(lt.dinv.numpy(), np.asarray(lj.dinv))
        for a, b in ((lt.p_lo, lj.p_lo), (lt.p_hi, lj.p_hi),
                     (lt.red_mask, lj.red_mask)):
            assert (a is None) == (b is None)
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("relax", [0, 1, 2, 3])
def test_pfmg_cycle_each_relax_type(relax):
    shape = (5, 4, 3)
    A, jA = both(stencil(shape, c=(1.0, 2.0, 4.0), var=0.3), shape)
    o = dict(relax_type=relax, num_pre_relax=2, num_post_relax=1)
    p = tls.PFMG(A, tls.PFMGOptions(**o))
    j = jls.PFMG(jA, jls.PFMGOptions(**o))
    f = np.random.default_rng(1).standard_normal(shape)
    close(p.cycle(t(f)).numpy(), j.cycle(jnp.asarray(f)))
    u = np.random.default_rng(2).standard_normal(shape)
    close(p.cycle(t(f), t(u)).numpy(), j.cycle(jnp.asarray(f), jnp.asarray(u)))


@pytest.mark.parametrize("shape", [(8, 6, 5), (7, 6, 5)], ids=["even", "odd"])
def test_pfmg_transfers(shape):
    """_restrict (P^T r) and _interp_add (x += P e) along cdir, nf even
    (the last odd point has no upper coarse neighbour) and odd."""
    A, jA = both(stencil(shape, c=(9.0, 1.0, 1.0), var=0.4), shape)
    p, j = tls.PFMG(A), jls.PFMG(jA)
    lt, lj = p.levels[0], j.levels[0]
    assert lt.cdir == lj.cdir == 0
    rng = np.random.default_rng(3)
    r = rng.standard_normal(shape)
    close(p._restrict(lt, t(r)).numpy(), j._restrict(lj, jnp.asarray(r)))
    cshape = (p.levels[1].A.shape)
    e = rng.standard_normal(cshape)
    x = rng.standard_normal(shape)
    close(p._interp_add(lt, t(x).clone(), t(e)).numpy(),
          j._interp_add(lj, jnp.asarray(x), jnp.asarray(e)))


def test_pfmg_solve_matches_jax():
    """test_struct.py's pfmgbase3d shape at 8^3 (c = 2, 3, 40): the same
    count and residual history, x within 1e-10."""
    shape = (8, 8, 8)
    A, jA = both(stencil(shape, c=(2.0, 3.0, 40.0)), shape)
    o = dict(tol=1e-8, max_iter=40, skip_relax=0)
    rt = tls.PFMG(A, tls.PFMGOptions(**o)).solve(torch.ones(shape, dtype=torch.float64))
    rj = jls.PFMG(jA, jls.PFMGOptions(**o)).solve(jnp.ones(shape))
    assert rt.converged and rt.num_iterations == int(rj.num_iterations)
    nt, nj = rt.res_norms.numpy(), np.asarray(rj.res_norms)
    assert np.array_equal(np.isnan(nt), np.isnan(nj))
    m = ~np.isnan(nj)
    close(nt[m], nj[m], 1e-10)
    close(rt.x.numpy(), rj.x, 1e-10)
    x_ref = spla.spsolve(A.to_scipy().tocsc(), np.ones(512)).reshape(shape)
    close(rt.x.numpy(), x_ref, 1e-6)


def test_pfmg_anisotropy_semicoarsens_z():
    shape = (8, 8, 8)
    p = tls.PFMG(both(stencil(shape, c=(1.0, 1.0, 100.0)), shape)[0])
    assert p.levels[0].cdir == 2 and p.levels[1].cdir == 2


# -- smoothers, Jacobi --------------------------------------------------------

def test_smoothers_match_jax():
    """point_jacobi, red_black_gs (RB and BR), point_relax over masks and
    (stride, index) pointsets; one full-lattice set is Jacobi bitwise."""
    shape = (6, 5, 4)
    A, jA = both(stencil(shape, var=0.5), shape)
    dinv = 1.0 / A.diagonal().numpy()
    rng = np.random.default_rng(5)
    u, f = rng.standard_normal(shape), rng.standard_normal(shape)
    close(tls.point_jacobi(A, t(dinv), t(u), t(f), 0.8).numpy(),
          jls.point_jacobi(jA, jnp.asarray(dinv), jnp.asarray(u), jnp.asarray(f), 0.8))
    red = tls.relax.parity_mask(shape, 0, device="cpu")
    jred = jls.relax._parity_mask(shape, 0)
    assert np.array_equal(red.numpy(), np.asarray(jred))
    for pre in (True, False):
        close(tls.red_black_gs(A, t(dinv), t(u), t(f), red, pre).numpy(),
              jls.red_black_gs(jA, jnp.asarray(dinv), jnp.asarray(u),
                               jnp.asarray(f), jred, pre))
    colors = [((2, 2, 1), (i, j, 0)) for i in (0, 1) for j in (0, 1)]
    close(tls.point_relax(A, t(dinv), t(u), t(f), colors, 0.9).numpy(),
          jls.point_relax(jA, jnp.asarray(dinv), jnp.asarray(u),
                          jnp.asarray(f), colors, 0.9))
    full = tls.pointset_mask(shape, (1, 1, 1), (0, 0, 0), device="cpu")
    assert np.array_equal(full.numpy(), np.asarray(jls.pointset_mask(
        shape, (1, 1, 1), (0, 0, 0))))
    assert torch.equal(tls.point_relax(A, t(dinv), t(u), t(f), [full], 0.8),
                       tls.point_jacobi(A, t(dinv), t(u), t(f), 0.8))


def test_struct_jacobi_matches_jax():
    shape = (6, 5, 4)
    A, jA = both(stencil(shape, var=0.5), shape)
    b = np.random.default_rng(6).standard_normal(shape)
    rt = tls.StructJacobi(A, tls.StructJacobiOptions(tol=1e-6, max_iter=300)).solve(t(b))
    rj = jls.StructJacobi(jA, jls.StructJacobiOptions(tol=1e-6, max_iter=300)).solve(
        jnp.asarray(b))
    assert rt.converged and rt.num_iterations == int(rj.num_iterations)
    nt, nj = rt.res_norms.numpy(), np.asarray(rj.res_norms)
    m = ~np.isnan(nj)
    assert np.array_equal(np.isnan(nt), np.isnan(nj))
    close(nt[m], nj[m], 1e-10)


def test_hybrid_switches_to_pfmg():
    """StructHybrid (tests/test_hybrid.py's case): DS-PCG stops
    unconverged (cf_tol 0.5, 10 iterations), then PFMG-PCG converges
    from its iterate."""
    shape = (10, 10, 10)
    A, _ = both(stencil(shape), shape)
    h = tls.StructHybrid(A, tls.StructHybridOptions(tol=1e-8, cf_tol=0.5,
                                                     dscg_max_iter=10))
    res = h.solve(torch.ones(shape, dtype=torch.float64))
    assert not h.dscg.converged and h._pfmg is not None
    assert res.converged
    x_ref = spla.spsolve(A.to_scipy().tocsc(), np.ones(1000))
    close(res.x.numpy().ravel(), x_ref, 1e-6)


# -- PCR, cyclic reduction ----------------------------------------------------

def test_pcr_tridiagonal():
    """test_parasails_cycred.py's case: n = 37 against a dense solve and
    the JAX package's PCR."""
    rng = np.random.default_rng(0)
    n = 37
    lower = rng.standard_normal(n) * 0.3
    upper = rng.standard_normal(n) * 0.3
    diag = 2.0 + np.abs(rng.standard_normal(n))
    rhs = rng.standard_normal(n)
    x = pcr_solve_batched(t(lower), t(diag), t(upper), t(rhs)).numpy()
    T = sp.diags([lower[1:], diag, upper[:-1]], [-1, 0, 1]).toarray()
    close(x, np.linalg.solve(T, rhs), 1e-9)
    close(x, jax_pcr(*(jnp.asarray(a) for a in (lower, diag, upper, rhs))))


def test_pcr_batched_with_zero_pivots():
    """A [3, 4, n] batch (n = 2 and 33) with some all-zero lines:
    the b = 0 guards give the JAX package's values."""
    rng = np.random.default_rng(1)
    for n in (2, 33):
        lo, up = rng.standard_normal((2, 3, 4, n)) * 0.4
        di = 2.0 + rng.random((3, 4, n))
        rhs = rng.standard_normal((3, 4, n))
        di[1, 2] = lo[1, 2] = up[1, 2] = 0.0
        got = pcr_solve_batched(t(lo), t(di), t(up), t(rhs)).numpy()
        close(got, jax_pcr(*(jnp.asarray(a) for a in (lo, di, up, rhs))))


def test_cyclic_reduction_struct_1d():
    n = 24
    ones = np.ones((n,))
    A, jA = both({(0,): 2.0 * ones, (-1,): -ones, (1,): -ones}, (n,))
    x = CyclicReduction(A).solve(torch.ones(n, dtype=torch.float64)).numpy()
    close(x, spla.spsolve(A.to_scipy().tocsc(), np.ones(n)), 1e-9)
    close(x, JaxCR(jA).solve(jnp.ones(n)))
    # a line along the last axis of a 3-D grid, one band missing (the
    # JAX package's CyclicReduction fails there: its zero band is [1, n]
    # against the others' [1, 1, n] in the fori_loop carry)
    A3, _ = both({(0, 0, 0): 3.0 * np.ones((1, 1, n)),
                  (0, 0, 1): -np.ones((1, 1, n))}, (1, 1, n))
    b = np.random.default_rng(2).standard_normal((1, 1, n))
    close(CyclicReduction(A3).solve(t(b)).numpy().ravel(),
          spla.spsolve(A3.to_scipy().tocsc(), b.ravel()), 1e-9)
    # constant bands (the JAX package's CyclicReduction fails on them)
    Ac = StructMatrix.from_dict({(0,): 2.0 * ones, (-1,): -1.0, (1,): -1.0},
                                StructGrid((n,)), device="cpu")
    close(CyclicReduction(Ac).solve(torch.ones(n, dtype=torch.float64)).numpy(),
          spla.spsolve(Ac.to_scipy().tocsc(), np.ones(n)), 1e-9)


# -- SMG ----------------------------------------------------------------------

def test_smg_dense_planes():
    """Planes of at most _PLANE_DENSE_MAX points: level 0 and the plane
    inverses bitwise; the weights (a batched product on the device) and
    the coarse operators within 1e-12; one cycle within 1e-12; a solve
    as test_struct.py's."""
    shape = (5, 4, 6)
    A, jA = both(stencil(shape, c=(1.0, 2.0, 3.0), var=0.3), shape)
    p, j = tls.SMG(A), jls.SMG(jA)
    assert p.num_levels == j.num_levels > 2
    same_matrix(p.levels[0].A, j.levels[0].A)
    for lt, lj in zip(p.levels, j.levels):
        assert lt.cdir == lj.cdir == 2
        assert lt.A.offsets == lj.A.offsets
        close(lt.A.data.numpy(), in_box(lj.A))
        assert isinstance(lt.planes, tsmg._DensePlanes)
        if lt is p.levels[0]:
            assert np.array_equal(lt.planes.inv.numpy(), np.asarray(lj.planes.inv))
        if lt.p_lo is not None:
            close(lt.p_lo.numpy(), lj.p_lo)
            close(lt.p_hi.numpy(), lj.p_hi)
    f = np.random.default_rng(1).standard_normal(shape)
    close(p.cycle(t(f)).numpy(), j.cycle(jnp.asarray(f)))
    res = p.solve(torch.ones(shape, dtype=torch.float64))
    x_ref = spla.spsolve(A.to_scipy().tocsc(), np.ones(A.to_scipy().shape[0]))
    assert res.converged and res.num_iterations <= 6
    close(res.x.numpy().ravel(), x_ref, 1e-6)


def test_smg_recursive_planes(monkeypatch):
    """Planes above the dense cap take the batched 2-D SMG (smg_plane.py):
    the 2-D SMG's host levels bitwise, the weights and one cycle within
    1e-12 of the JAX package's."""
    monkeypatch.setattr(tsmg, "_PLANE_DENSE_MAX", 16)
    monkeypatch.setattr(jsmg, "_PLANE_DENSE_MAX", 16)
    shape = (5, 4, 3)
    A, jA = both(stencil(shape, c=(1.0, 2.0, 3.0), var=0.3), shape)
    p, j = tls.SMG(A, tls.SMGOptions(max_levels=2)), jls.SMG(
        jA, jls.SMGOptions(max_levels=2))
    lt, lj = p.levels[0], j.levels[0]
    assert isinstance(lt.planes, tsmg._RecursivePlanes)
    s2, js2 = lt.planes.smg2, lj.planes.smg2
    assert len(s2.levels) == len(js2.levels) > 1
    for a, b in zip(s2.levels, js2.levels):
        assert list(a["entries"]) == list(b["entries"])
        for k in a["entries"]:
            assert np.array_equal(a["entries"][k].numpy(), np.asarray(b["entries"][k]))
        for k in ("p_lo", "p_hi"):
            assert (k in a) == (k in b)
            if k in a:
                assert np.array_equal(a[k].numpy(), np.asarray(b[k]))
    close(lt.p_lo.numpy(), lj.p_lo)
    close(lt.p_hi.numpy(), lj.p_hi)
    f = np.random.default_rng(2).standard_normal(shape)
    close(p.cycle(t(f)).numpy(), j.cycle(jnp.asarray(f)))


# -- SparseMSG ----------------------------------------------------------------

MSG_SHAPE = (5, 4, 3)
# the JAX package's SparseMSG cycle of the seed-4 right-hand side on
# MSG_SHAPE (its ||u||_2 and six entries of u, flat index -> value);
# test_sparse_msg_cycle_matches_live_jax (slow) recomputes them
MSG_CYCLE_NORM = 0.039277606368091446
MSG_CYCLE_AT = {0: -0.0018614407788887502, 7: -0.004526288983371305,
                19: -0.00983088619611085, 33: 0.0056992030147022255,
                46: -0.004083289927310252, 59: 0.0007096447625903168}


def msg_pair():
    A, jA = both(stencil(MSG_SHAPE, c=(1.0, 10.0, 100.0), var=0.2), MSG_SHAPE)
    return tls.SparseMSG(A), jls.SparseMSG(jA)


def msg_rhs():
    return np.random.default_rng(4).standard_normal(MSG_SHAPE)


def test_sparse_msg_hierarchy_bitwise():
    """The DAG of semicoarsened grids: the same grids and operators, the
    same transfer matrices (scipy, bitwise) frozen into the port's ELL /
    dense forms, the same visit weights and inverse diagonals; a short
    solve converges as the JAX package's test."""
    p, j = msg_pair()
    assert p.nl == j.nl and p.keys == j.keys and len(p.keys) > 4
    for g in p.keys:
        same_matrix(p.grids[g], j.grids[g])
        assert np.array_equal(p.dinv[g].numpy(), np.asarray(j.dinv[g]))
        for a, b in zip(p.visit[g], j.visit[g]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert sorted(p.Pmat) == sorted(j.Pmat)
    for k, (P, cshape) in p.Pmat.items():
        jP, jcshape = j.Pmat[k]
        assert cshape == jcshape and (P != jP).nnz == 0
    res = p.solve(torch.ones(MSG_SHAPE, dtype=torch.float64))
    assert res.converged and res.num_iterations <= 15


def test_sparse_msg_cycle():
    """One cycle within 1e-12 of the JAX package's (pinned; the JAX
    cycle's eager dispatch over the DAG's many shapes takes ~15 s)."""
    u = tls.SparseMSG(both(stencil(MSG_SHAPE, c=(1.0, 10.0, 100.0), var=0.2),
                           MSG_SHAPE)[0]).cycle(t(msg_rhs())).numpy()
    assert abs(np.linalg.norm(u) - MSG_CYCLE_NORM) <= TOL * MSG_CYCLE_NORM
    for i, v in MSG_CYCLE_AT.items():
        assert abs(u.ravel()[i] - v) <= TOL * MSG_CYCLE_NORM


@pytest.mark.slow
def test_sparse_msg_cycle_matches_live_jax():
    p, j = msg_pair()
    uj = np.asarray(j.cycle(jnp.asarray(msg_rhs())))
    close(p.cycle(t(msg_rhs())).numpy(), uj)
    assert abs(np.linalg.norm(uj) - MSG_CYCLE_NORM) <= TOL * MSG_CYCLE_NORM
    for i, v in MSG_CYCLE_AT.items():
        assert abs(uj.ravel()[i] - v) <= TOL * MSG_CYCLE_NORM
