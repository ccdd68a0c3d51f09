"""The port's sstruct interface (hypre_tpu_torch/sstruct/, Split, SysPFMG)
on the CPU against the JAX package's (hypre_tpu/sstruct/,
hypre_tpu/solvers/sstruct_ls/) on the same inputs, made from a seed.

  * grid / vector helpers, `sstruct_matvec` with alpha / beta on every
    part (1e-12 relative), the monolithic `to_scipy` and the frozen U
    (the built-in layout's U: a 2-offset DIA matrix) bitwise;
  * `convert.sstruct_matrix_from_numpy` / `sstruct_vector_from`: the
    JAX package's operator carried over, bitwise;
  * Split (PFMG, SMG and Jacobi sub-solves) against the JAX package run
    live, and Split-preconditioned PCG against its pinned numbers
    (JAX_SPLIT_PCG): the same count and residual history (1e-12
    relative), x within 1e-12;
  * SysPFMG: the hierarchy bitwise (each level's blocks, nodewise
    inverses, interpolation weights) live, the solve's count, history and
    ||x|| against the pinned JAX_SYSPFMG (the slow tier reruns the pins);
  * neighbors: `build_u_from_neighbors` on a rotated part, bitwise;
  * FAC: the composite AMR operators bitwise, one cycle within 1e-12 of
    the JAX package's live, a 2-level solve against its pinned count,
    history and ||x|| (JAX_FAC).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.ops.csr import CSRMatrix as JCSR
from hypre_tpu.solvers.krylov import PCGOptions as JPCGOptions
from hypre_tpu.solvers.krylov import pcg as jpcg
from hypre_tpu.solvers.sstruct_ls import SplitOptions as JSplitOptions
from hypre_tpu.solvers.sstruct_ls import SStructSplit as JSplit
from hypre_tpu.solvers.sstruct_ls.sys_pfmg import SysPFMG as JSysPFMG
from hypre_tpu.solvers.sstruct_ls.sys_pfmg import SysPFMGOptions as JSysOpts
from hypre_tpu.sstruct import SStructGrid as JGrid
from hypre_tpu.sstruct import SStructMatrix as JMatrix
from hypre_tpu.sstruct import sstruct_matvec as jmatvec
from hypre_tpu.sstruct.neighbors import NeighborPart as JNeighbor
from hypre_tpu.sstruct.neighbors import build_u_from_neighbors as jbuild_u
from hypre_tpu.sstruct.vector import pack_vector as jpack
from hypre_tpu.struct import StructGrid as JSGrid
from hypre_tpu.struct import StructMatrix as JSMatrix

from hypre_tpu_torch.convert import (sstruct_grid_from,
                                     sstruct_matrix_from_numpy,
                                     sstruct_vector_from,
                                     struct_matrix_from_numpy)
from hypre_tpu_torch.drivers.sstruct import build_two_part
from hypre_tpu_torch.ops.dia import DIAMatrix
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from hypre_tpu_torch.solvers.krylov.common import tzeros_like
from hypre_tpu_torch.solvers.sstruct_ls import SplitOptions, SStructSplit
from hypre_tpu_torch.solvers.sstruct_ls.sys_pfmg import SysPFMG, SysPFMGOptions
from hypre_tpu_torch.sstruct import SStructGrid, SStructMatrix, sstruct_matvec
from hypre_tpu_torch.sstruct.neighbors import (NeighborPart,
                                               build_u_from_neighbors)
from hypre_tpu_torch.sstruct.vector import full, pack_vector, unpack_vector, zeros
from hypre_tpu_torch.struct import StructGrid, StructMatrix
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")


def jax_two_part(nx, ny, coef):
    """The JAX package's two-part 2-D problem (tests/test_sstruct.py's
    layout) with seeded variable coefficients: a 5-point stencil a part,
    the interface couplings in U."""
    g = JGrid(parts=((JSGrid((nx, ny)),), (JSGrid((nx, ny)),)))
    smats = {(p, 0, 0): JSMatrix.from_dict(coef[p], g.grid(p)) for p in (0, 1)}
    n = g.total_size
    offs = g.offsets()
    rows, cols = [], []
    for j in range(ny):
        a = offs[(0, 0)] + (nx - 1) * ny + j
        b = offs[(1, 0)] + j
        rows += [a, b]
        cols += [b, a]
    U = JCSR.from_coo(rows, cols, [-1.0] * len(rows), (n, n))
    return g, JMatrix(g, smats, U)


def seeded_coefs(shape, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        ent = {(0, 0): 4.0 + rng.random(shape)}
        for o in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ent[o] = -(0.5 + 0.5 * rng.random(shape))
        out.append(ent)
    return out


@pytest.fixture(scope="module")
def problem():
    """(JAX matrix, the port's copy on the CPU, the port's own build)."""
    shape = (6, 5)
    coef = seeded_coefs(shape, 3)
    jg, jA = jax_two_part(*shape, coef)
    g = SStructGrid(parts=((StructGrid(shape),), (StructGrid(shape),)))
    smats = {(p, 0, 0): StructMatrix.from_dict(coef[p], g.grid(p), device=CPU)
             for p in (0, 1)}
    from hypre_tpu_torch.ops.csr import CSRMatrix
    U = jA.u_host
    A = SStructMatrix(g, smats, CSRMatrix(U.indptr, U.indices, U.data, U.shape),
                      device=CPU)
    return jA, sstruct_matrix_from_numpy(jA, CPU), A


def rand_vec(g, seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(rng.standard_normal(gr.shape) for gr in pv)
                 for pv in g.parts)


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().ravel()
    if isinstance(x, (tuple, list)):
        return np.concatenate([flat(v) for v in x])
    return np.asarray(x).ravel()


def test_grid_and_vector_helpers():
    jg = JGrid(parts=((JSGrid((3, 4)), JSGrid((4, 4))), (JSGrid((2, 2)),)))
    g = sstruct_grid_from(jg)
    assert g.offsets() == jg.offsets() and g.sizes() == jg.sizes()
    assert g.total_size == jg.total_size and g.nvars(0) == 2
    assert [[t.name for t in pv] for pv in g.var_types] == [
        [t.name for t in pv] for pv in jg.var_types]
    x = rand_vec(g, 0)
    xt = sstruct_vector_from(x, CPU)
    packed = pack_vector(xt)
    assert np.array_equal(packed.numpy(), np.asarray(jpack(x)))
    back = unpack_vector(packed, g)
    assert all(torch.equal(a, b) for pa, pb in zip(back, xt)
               for a, b in zip(pa, pb))
    assert float(pack_vector(full(g, 2.5, device=CPU)).sum()) == 2.5 * 32
    assert float(pack_vector(zeros(g, device=CPU)).abs().sum()) == 0.0


@pytest.mark.parametrize("alpha, beta", [(1.0, 0.0), (-0.5, 2.0)])
def test_matvec_matches_jax(problem, alpha, beta):
    jA, A, A2 = problem
    x, y = rand_vec(jA.grid, 1), rand_vec(jA.grid, 2)
    jx = tuple(tuple(jnp.asarray(v) for v in pv) for pv in x)
    jy = tuple(tuple(jnp.asarray(v) for v in pv) for pv in y)
    want = flat(jax.tree.map(np.asarray, jmatvec(jA, jx, alpha, beta, jy)))
    for M in (A, A2):
        got = flat(sstruct_matvec(M, sstruct_vector_from(x, CPU), alpha, beta,
                                  sstruct_vector_from(y, CPU)))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_carried_and_built_operators_are_the_jax_one(problem):
    jA, A, A2 = problem
    want = jA.to_scipy()
    for M in (A, A2):
        got = M.to_scipy()
        assert (got != want).nnz == 0
        for k, sm in jA.smats.items():
            assert np.array_equal(M.smats[k].data.numpy(), np.asarray(sm.data))
    # the U of two parts joined on a plane lies on two diagonals
    assert isinstance(A.umat, type(A2.umat))


def test_builtin_layout_u_is_two_diagonals():
    from hypre_tpu.drivers import sstruct as jdrv

    g, A = build_two_part(3, 40, 40, 3, device=CPU)  # 9,600 rows: off dense
    jg, jA = jdrv.build_two_part(3, 40, 40, 3)
    assert (A.to_scipy() != jA.to_scipy()).nnz == 0
    assert isinstance(A.umat, DIAMatrix)
    assert A.umat.offsets == (-1600, 1600)


SPLITS = [("pfmg", 1e-8), ("smg", 1e-8), ("jacobi", 1e-6)]


@pytest.mark.parametrize("ssolver, tol", SPLITS, ids=[s for s, _ in SPLITS])
def test_split_matches_jax(problem, ssolver, tol):
    jA, A, _ = problem
    b = rand_vec(jA.grid, 4)
    jb = tuple(tuple(jnp.asarray(v) for v in pv) for pv in b)
    jres = JSplit(jA, JSplitOptions(tol=tol, max_iter=60,
                                    ssolver=ssolver)).solve(jb)
    res = SStructSplit(A, SplitOptions(tol=tol, max_iter=60,
                                       ssolver=ssolver)).solve(
        sstruct_vector_from(b, CPU))
    assert res.num_iterations == int(jres.num_iterations) > 3
    assert res.converged == bool(jres.converged)
    hj, h = np.asarray(jres.res_norms), res.res_norms.numpy()
    assert np.array_equal(np.isnan(hj), np.isnan(h))
    ok = ~np.isnan(hj)
    assert np.abs(h[ok] - hj[ok]).max() <= 1e-12 * hj[0]
    xj = flat(jax.tree.map(np.asarray, jres.x))
    assert np.abs(flat(res.x) - xj).max() <= 1e-12 * np.abs(xj).max()


# JAX_SPLIT_PCG: PCG (two-norm, tol 1e-10) preconditioned by one Split-
# PFMG step on `problem`, b = ones; JAX_SYSPFMG: SysPFMG on `syspfmg`'s
# system from default_rng(6): the JAX package's count, residual history
# (and ||x||_2); the slow tier reruns them
JAX_SPLIT_PCG = (14, [
    7.745966692414834, 1.6973246700951714, 0.37590086168145875,
    0.04372061201721032, 0.007097809003211961, 0.001086772789319588,
    0.00022959231193171324, 5.7617855664689115e-05, 1.007318143756608e-05,
    9.951156747165724e-07, 2.2380450435371168e-07, 5.449075846598726e-08,
    1.0116999284735259e-08, 1.4498560194911192e-09, 3.33986638716768e-10])
JAX_SYSPFMG = (14, [
    15.637437949623894, 0.973428388608838, 0.17907122275093687,
    0.04096937285905897, 0.010069793765282982, 0.0025467880417827868,
    0.0006533769553689926, 0.00016907258635778035, 4.4010165530919986e-05,
    1.1507128623239994e-05, 3.0195068699449253e-06, 7.947350941664551e-07,
    2.097364810497347e-07, 5.548749577598105e-08, 1.4713985711362163e-08],
    2.853241930837869)


def assert_history(got, want):
    want = np.asarray(want)
    assert np.abs(got.numpy()[:len(want)] - want).max() <= 1e-12 * want[0]
    assert np.isnan(got.numpy()[len(want):]).all()


def jax_split_pcg(jA):
    jb = tuple(tuple(jnp.ones(g.shape) for g in pv) for pv in jA.grid.parts)
    js = JSplit(jA, JSplitOptions(ssolver="pfmg"))
    return jpcg(lambda x: jmatvec(jA, x), jb,
                M=lambda r: js._step(jax.tree.map(jnp.zeros_like, r), r),
                opts=JPCGOptions(tol=1e-10, max_iter=50, two_norm=True))


def test_split_pcg_matches_jax(problem):
    _, A, _ = problem
    s = SStructSplit(A, SplitOptions(ssolver="pfmg"))
    res = pcg(lambda x: sstruct_matvec(A, x), full(A.grid, 1.0, device=CPU),
              M=lambda r: s._step(tzeros_like(r), r),
              opts=PCGOptions(tol=1e-10, max_iter=50, two_norm=True))
    assert res.num_iterations == JAX_SPLIT_PCG[0]
    assert_history(res.res_norms, JAX_SPLIT_PCG[1])


@pytest.mark.slow
def test_jax_split_pcg_matches_its_pin(problem):
    jres = jax_split_pcg(problem[0])
    assert int(jres.num_iterations) == JAX_SPLIT_PCG[0]
    n = JAX_SPLIT_PCG[0] + 1
    assert np.abs(np.asarray(jres.res_norms)[:n]
                  - JAX_SPLIT_PCG[1]).max() <= 1e-12 * JAX_SPLIT_PCG[1][0]


def two_var(shape, seed):
    """Two coupled variables [[A0, C], [C, A1]] on one grid (seeded
    7-point A's, a diagonal coupling C), for the JAX package and the
    port."""
    rng = np.random.default_rng(seed)
    nd = len(shape)
    ents = []
    for _ in range(2):
        e = {(0,) * nd: 2.0 * nd + rng.random(shape)}
        for d in range(nd):
            for s in (-1, 1):
                o = [0] * nd
                o[d] = s
                e[tuple(o)] = -(0.6 + 0.4 * rng.random(shape))
        ents.append(e)
    c = {(0,) * nd: 0.2 * rng.random(shape)}
    jg = JSGrid(shape)
    jb = {(0, 0): JSMatrix.from_dict(ents[0], jg),
          (1, 1): JSMatrix.from_dict(ents[1], jg),
          (0, 1): JSMatrix.from_dict(c, jg), (1, 0): JSMatrix.from_dict(c, jg)}
    pb = {k: struct_matrix_from_numpy(m, CPU) for k, m in jb.items()}
    return jg, jb, StructGrid(shape), pb


@pytest.fixture(scope="module")
def syspfmg():
    jg, jb, g, pb = two_var((6, 5, 4), 5)
    opts = dict(tol=1e-9, max_iter=40)
    return (JSysPFMG(jb, jg, JSysOpts(**opts)),
            SysPFMG(pb, g, SysPFMGOptions(**opts), device=CPU))


def test_syspfmg_hierarchy_is_the_jax_one(syspfmg):
    js, s = syspfmg
    assert len(s.levels) == len(js.levels) > 3
    for lj, l in zip(js.levels, s.levels):
        assert l.cdir == lj.cdir and set(l.blocks) == set(lj.blocks)
        for k, bj in lj.blocks.items():
            assert l.blocks[k].offsets == tuple(tuple(o) for o in bj.offsets)
            assert (l.blocks[k].to_scipy() != bj.to_scipy()).nnz == 0
        assert np.array_equal(l.node_inv.numpy(), np.asarray(lj.node_inv))
        if lj.p_lo is not None:
            for a, b in zip(l.p_lo + l.p_hi, lj.p_lo + lj.p_hi):
                assert np.array_equal(a.numpy(), np.asarray(b))


def syspfmg_rhs():
    rng = np.random.default_rng(6)
    return [rng.standard_normal((6, 5, 4)) for _ in range(2)]


def test_syspfmg_solve_matches_jax(syspfmg):
    _, s = syspfmg
    res = s.solve(tuple(torch.from_numpy(v) for v in syspfmg_rhs()))
    iters, hist, xnorm = JAX_SYSPFMG
    assert res.num_iterations == iters and res.converged
    assert_history(res.res_norms, hist)
    assert abs(np.linalg.norm(flat(res.x)) - xnorm) <= 1e-12 * xnorm


@pytest.mark.slow
def test_jax_syspfmg_matches_its_pin(syspfmg):
    jres = syspfmg[0].solve(tuple(jnp.asarray(v) for v in syspfmg_rhs()))
    iters, hist, xnorm = JAX_SYSPFMG
    assert int(jres.num_iterations) == iters
    assert np.abs(np.asarray(jres.res_norms)[:iters + 1]
                  - hist).max() <= 1e-12 * hist[0]
    x = flat([np.asarray(v) for v in jres.x])
    assert abs(np.linalg.norm(x) - xnorm) <= 1e-12 * xnorm


def test_neighbor_relations_build_the_jax_u():
    """GridSetNeighborPart with a rotated part (tests/test_sstruct.py's
    case, seeded coefficients): the same U entries, bitwise."""
    nx, ny = 5, 4
    rng = np.random.default_rng(7)

    def ent(shape):
        o = np.ones(shape)
        return {(0, 0): 4.0 + rng.random(shape), (-1, 0): -o,
                (1, 0): -(0.5 + rng.random(shape)), (0, -1): -o, (0, 1): -o}

    stencils = {0: ent((nx, ny)), 1: ent((ny, nx))}
    rels = [dict(part=0, ilower=(nx, 0), iupper=(nx, ny - 1), nbor_part=1,
                 nbor_ilower=(0, 0), nbor_iupper=(ny - 1, 0), coord=(1, 0),
                 dir=(1, -1)),
            dict(part=1, ilower=(0, -1), iupper=(ny - 1, -1), nbor_part=0,
                 nbor_ilower=(nx - 1, 0), nbor_iupper=(nx - 1, ny - 1),
                 coord=(1, 0), dir=(-1, 1))]
    jg = JGrid(parts=((JSGrid((nx, ny)),), (JSGrid((ny, nx)),)))
    Uj = jbuild_u(jg, stencils, [JNeighbor(**r) for r in rels])
    U = build_u_from_neighbors(sstruct_grid_from(jg), stencils,
                               [NeighborPart(**r) for r in rels])
    assert U.nnz == Uj.nnz > 0
    for a, b in ((U.indptr, Uj.indptr), (U.indices, Uj.indices),
                 (U.data, Uj.data)):
        assert np.array_equal(a, np.asarray(b))
    assert NeighborPart(**rels[0]).map_index((nx, 2)) == JNeighbor(
        **rels[0]).map_index((nx, 2))


# FAC (solvers/sstruct_ls/fac.py): the JAX package's 2-level solve of
# build_composite_poisson((6, 6, 6), (2, 2, 2), (2, 2, 2)), b = ones, tol
# 1e-7: count, residual history, ||x||_2 (the slow tier reruns it)
JAX_FAC = (18, [
    6.322310970197841, 2.549469068356027, 1.0280722278777465,
    0.41456965249815675, 0.16717502147348337, 0.06741325043018169,
    0.027184362194203917, 0.010962081537230457, 0.004420454332180102,
    0.0017825461739654465, 0.0007188109238411441, 0.00028986017404770276,
    0.00011688598171356731, 4.713421830212831e-05, 1.900685182693255e-05,
    7.664504246085492e-06, 3.0907078103373542e-06, 1.2463265020235645e-06],
    28.209575582715996)
AMR3 = ((10, 10), [((2, 2), (5, 5), 2), ((2, 2), (5, 5), 4)])


def test_fac_composites_are_the_jax_ones():
    from hypre_tpu.solvers.sstruct_ls.fac import build_composite_amr as jamr
    from hypre_tpu.solvers.sstruct_ls.fac import build_composite_poisson as jp
    from hypre_tpu_torch.solvers.sstruct_ls.fac import (build_composite_amr,
                                                        build_composite_poisson)

    A, ranges, maps = build_composite_amr(*AMR3)
    Aj, rj, mj = jamr(*AMR3)
    assert (A != Aj).nnz == 0 and ranges == rj
    assert all(np.array_equal(a, b) for a, b in zip(maps, mj))
    got, want = (build_composite_poisson((6, 6, 6), (2, 2, 2), (2, 2, 2)),
                 jp((6, 6, 6), (2, 2, 2), (2, 2, 2)))
    assert (got[0] != want[0]).nnz == 0 and got[3] == want[3]
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


def test_fac_cycle_matches_jax():
    """One multiplicative FAC cycle on the 3-level composite (the GMRES
    preconditioner of tests/test_sstruct.py::test_fac_multilevel_amr)."""
    from hypre_tpu.solvers.sstruct_ls.fac import FAC as JFAC
    from hypre_tpu.solvers.sstruct_ls.fac import FACOptions as JFACOptions
    from hypre_tpu_torch.solvers.sstruct_ls.fac import (FAC, FACOptions,
                                                        build_composite_amr)

    A, ranges, _ = build_composite_amr(*AMR3)
    b = np.random.default_rng(8).standard_normal(A.shape[0])
    want = np.asarray(JFAC(A, ranges, JFACOptions(max_iter=1)).cycle(
        jnp.asarray(b), jnp.zeros(A.shape[0])))
    u0 = torch.zeros(A.shape[0], dtype=torch.float64)
    got = FAC(A, ranges, FACOptions(max_iter=1), device=CPU).cycle(
        torch.from_numpy(b), u0).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    assert not u0.any()  # the caller's u is left as it was


def fac_poisson():
    from hypre_tpu_torch.solvers.sstruct_ls.fac import build_composite_poisson

    A, _, _, nc = build_composite_poisson((6, 6, 6), (2, 2, 2), (2, 2, 2))
    return A, nc


def test_fac_solve_matches_jax():
    from hypre_tpu_torch.solvers.sstruct_ls.fac import FAC, FACOptions

    A, nc = fac_poisson()
    res = FAC(A, nc, FACOptions(tol=1e-7, max_iter=30), device=CPU).solve(
        torch.ones(A.shape[0], dtype=torch.float64))
    iters, hist, xnorm = JAX_FAC
    assert res.num_iterations == iters and res.converged
    assert np.abs(res.res_norms.numpy() - hist).max() <= 1e-12 * hist[0]
    assert abs(np.linalg.norm(res.x.numpy()) - xnorm) <= 1e-12 * xnorm


@pytest.mark.slow
def test_jax_fac_matches_its_pin():
    from hypre_tpu.solvers.sstruct_ls.fac import FAC as JFAC
    from hypre_tpu.solvers.sstruct_ls.fac import FACOptions as JFACOptions

    A, nc = fac_poisson()
    res = JFAC(A, nc, JFACOptions(tol=1e-7, max_iter=30)).solve(
        jnp.ones(A.shape[0]))
    iters, hist, xnorm = JAX_FAC
    assert res.num_iterations == iters
    assert np.abs(np.asarray(res.res_norms) - hist).max() <= 1e-12 * hist[0]
    assert abs(np.linalg.norm(np.asarray(res.x)) - xnorm) <= 1e-12 * xnorm
