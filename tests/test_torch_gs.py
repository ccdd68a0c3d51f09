"""The port's Gauss-Seidel family against the JAX package, on the CPU.

Host setup is held bitwise (the wavefront levels, the padded slabs of a
schedule); one sweep within 1e-12 of the JAX step in f64 (torch and XLA
sum a row's padded slots in their own order); the solves to the same
iteration counts, their f64 residual histories within 1e-10 (f32/bf16:
the count, and 1e-4 on the history).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu import native as jax_native
from hypre_tpu.models import laplacian_5pt_2d
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops import CSRMatrix as JaxCSR
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg import relax as jrelax
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch import native
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, spmv
from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.relax import (GSSchedule, build_gs_schedule,
                                               gauss_seidel)
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4)


def _matrix(kind):
    """scipy CSR: a 2D 5-point Laplacian, a random nonsymmetric matrix
    (its wavefronts hold rows that read same-wavefront neighbours), or a
    random symmetric one."""
    if kind == "5pt":
        return laplacian_5pt_2d(9, 7).to_scipy().tocsr()
    rng = np.random.default_rng(3)
    n = 120
    B = sp.random(n, n, 0.06, random_state=rng)
    if kind == "sym":
        B = B + B.T
    M = (B + sp.diags(9.0 + rng.random(n))).tocsr()
    M.sort_indices()
    return M


def _mask(n):
    return np.random.default_rng(7).random(n) < 0.4


@pytest.mark.parametrize("kind", ["5pt", "nonsym"])
@pytest.mark.parametrize("forward", [True, False])
def test_gs_levels_bitwise(kind, forward):
    M = _matrix(kind)
    got = native.gs_levels(M.indptr, M.indices, M.shape[0], forward)
    want = jax_native.gs_levels(M.indptr, M.indices, M.shape[0], forward)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["5pt", "nonsym"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("forward", [True, False])
def test_build_gs_schedule_bitwise(kind, masked, forward):
    """rows, acols, adata, dinv: the JAX package's leaves, bit for bit,
    with and without a divisor; the kernel's layout lists the same rows
    in the same wavefronts."""
    M = _matrix(kind)
    mask = _mask(M.shape[0]) if masked else None
    for div in (None, np.where(M.diagonal() == 0, 1.0, M.diagonal()) * 1.5):
        sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward, div,
                                  mask=mask, device="cpu")
        ref = jrelax.build_gs_schedule(JaxCSR.from_scipy(M), forward, div,
                                       mask=mask)
        for got, name in zip(sched.host_slabs(),
                             ("rows", "acols", "adata", "dinv")):
            want = np.asarray(getattr(ref, name))
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        rows = np.asarray(ref.rows)
        assert np.array_equal(sched.order.numpy(), rows[rows < M.shape[0]])
        assert np.array_equal(sched.widths, (rows < M.shape[0]).sum(1))


@pytest.mark.parametrize("kind", ["5pt", "nonsym", "sym"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("omega", [1.0, 0.7])
def test_gauss_seidel_matches_jax(kind, masked, omega):
    """One sweep each way, the plain form and the omega / v form, within
    1e-12 (f64) of the JAX step; hazard flags only where a wavefront
    reads itself."""
    M = _matrix(kind)
    n = M.shape[0]
    mask = _mask(n) if masked else None
    rng = np.random.default_rng(2)
    u, f, v = (rng.standard_normal(n) for _ in range(3))
    for forward in (True, False):
        sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward,
                                  mask=mask, device="cpu")
        if kind != "nonsym":
            assert not sched.any_hazard
        ref_s = jrelax.build_gs_schedule(JaxCSR.from_scipy(M), forward,
                                         mask=mask)
        for vv in (None, v):
            got = gauss_seidel(sched, torch.from_numpy(u), torch.from_numpy(f),
                               0.9, omega,
                               None if vv is None else torch.from_numpy(vv))
            want = np.asarray(jrelax.gauss_seidel(
                ref_s, jnp.asarray(u), jnp.asarray(f), 0.9, omega,
                None if vv is None else jnp.asarray(vv)))
            assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert gs_sweep_cuda.launches == 0  # CPU tensors: the plain version


def test_nonsymmetric_pattern_has_hazard_wavefronts():
    """The random nonsymmetric matrix really has wavefronts whose rows
    read each other, so the comparison above covers that case."""
    M = _matrix("nonsym")
    for forward in (True, False):
        sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward,
                                  device="cpu")
        assert sched.any_hazard and int(sched.hazard.sum()) >= 2


def test_f32_vectors_keep_f64_slabs():
    """With f32 vectors the sweep sums in the slabs' f64 and rounds each
    update to f32, as the JAX step does: bitwise here on a pattern whose
    rows sum in one order (the 5-point rows, width 5)."""
    M = _matrix("5pt")
    n = M.shape[0]
    rng = np.random.default_rng(4)
    u, f = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), True, device="cpu")
    assert sched.host_slabs()[2].dtype == np.float64
    got = gauss_seidel(sched, torch.from_numpy(u), torch.from_numpy(f))
    want = np.asarray(jrelax.gauss_seidel(
        jrelax.build_gs_schedule(JaxCSR.from_scipy(M), True),
        jnp.asarray(u), jnp.asarray(f)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_gs_parity_with_sequential():
    """Mirrors tests/test_amg.py::test_amg_gs_parity_with_sequential: the
    level-scheduled sweep equals a literal sequential sweep."""
    M = _matrix("5pt")
    n = M.shape[0]
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal(n)
    f = rng.standard_normal(n)
    d = M.diagonal()
    for forward, rows in ((True, range(n)), (False, range(n - 1, -1, -1))):
        u_ref = u0.copy()
        for i in rows:
            lo, hi = M.indptr[i], M.indptr[i + 1]
            u_ref[i] += (f[i] - M.data[lo:hi] @ u_ref[M.indices[lo:hi]]) / d[i]
        sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward,
                                  device="cpu")
        u = gauss_seidel(sched, torch.from_numpy(u0), torch.from_numpy(f))
        np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-13)


def test_masked_gs_exact_vs_sequential():
    """Mirrors tests/test_amg.py::test_masked_gs_exact_vs_sequential."""
    rng = np.random.default_rng(3)
    n = 80
    B = sp.random(n, n, 0.07, random_state=rng)
    M = (B + B.T + sp.diags(np.ones(n) * 9)).tocsr()
    f = rng.standard_normal(n)
    mask = rng.random(n) < 0.4
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), True, mask=mask,
                              device="cpu")
    u = gauss_seidel(sched, torch.zeros(n, dtype=torch.float64),
                     torch.from_numpy(f))
    Md = M.toarray()
    ur = np.zeros(n)
    for i in range(n):
        if mask[i]:
            ur[i] = (f[i] - Md[i, :i] @ ur[:i] - Md[i, i + 1:] @ ur[i + 1:]) / Md[i, i]
    np.testing.assert_allclose(u.numpy(), ur, atol=1e-14)


@pytest.mark.parametrize("masked", [False, True])
def test_schedule_from_jax_slabs_is_the_ports_own(masked):
    """convert's path (GSSchedule.from_slabs over the JAX leaves) lays the
    kernel's schedule out as the port's own build does."""
    M = _matrix("nonsym")
    mask = _mask(M.shape[0]) if masked else None
    own = build_gs_schedule(CSRMatrix.from_scipy(M), False, mask=mask,
                            device="cpu")
    ref = jrelax.build_gs_schedule(JaxCSR.from_scipy(M), False, mask=mask)
    got = GSSchedule.from_slabs(*(np.asarray(getattr(ref, k)) for k in (
        "rows", "acols", "adata", "dinv")), int(ref.n), "cpu")
    for name in ("order", "wf_ptr", "hazard"):
        assert torch.equal(getattr(got, name), getattr(own, name)), name
    keep = np.flatnonzero(mask) if masked else np.arange(M.shape[0])
    for r in keep:  # every scheduled row: its entries and its divisor
        a, b = (slice(int(s.mat.indptr[r]), int(s.mat.indptr[r + 1]))
                for s in (got, own))
        assert torch.equal(got.mat.indices[a], own.mat.indices[b])
        assert torch.equal(got.mat.data[a], own.mat.data[b])
    assert torch.equal(got.mat.dinv[keep], own.mat.dinv[keep])


# -- the hierarchy ---------------------------------------------------------

PINS = [  # tests/test_options.py::test_outer_weight_oracle_pins (hypre 2.20)
    (dict(relax_down=4, relax_up=4, omega=0.7), 23),
    (dict(relax_down=4, relax_up=4, relax_weight=0.9, omega=0.8), 24),
    (dict(relax_down=13, relax_up=13, omega=0.5), 33),
]


@pytest.mark.parametrize("kw,want", PINS)
def test_outer_weight_oracle_pins(kw, want):
    """hypre's serial solver 0 at 12^3, tol 1e-8: the same counts
    through the port's BoomerAMG.solve."""
    A = laplacian_7pt(12, 12, 12)
    amg = BoomerAMG(A, BoomerAMGOptions(**SLICE, dtype="float64",
                                        embed_level1=False, **kw),
                    device="cpu")
    r = amg.solve(torch.ones(1728, dtype=torch.float64), tol=1e-8,
                  max_iter=100)
    assert r.num_iterations == want, (kw, r.num_iterations)
    assert float(r.rel_residual_norm) < 1e-8 and r.converged


@pytest.mark.parametrize("rlx,order", [(17, 0), (15, 0), (13, 1), (3, 1)])
def test_smoother_variants_fcf_cg_cforder(rlx, order):
    """Mirrors tests/test_amg.py::test_smoother_variants_fcf_cg_cforder:
    relax 17 (FCF-Jacobi), 15 (CG smoother) and CF-ordered GS converge
    through BoomerAMG.solve at 8^3."""
    A = laplacian_7pt(8, 8, 8)
    b = torch.from_numpy(A.to_scipy() @ np.ones(512))
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=rlx, relax_up={3: 4, 13: 14}.get(rlx, rlx),
        relax_order=order, embed_level1=False), device="cpu")
    if rlx in (13, 3):
        assert isinstance(amg.levels[0].gs_fwd, tuple)
    res = amg.solve(b, tol=1e-8, max_iter=20)
    assert res.converged, f"relax {rlx} order {order}"


NX = 24
CONFIGS = {
    "f64": dict(dtype="float64"),
    "f32": dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02),
}
GS = dict(SLICE, relax_down=13, relax_up=14, embed_level1=False,
          relocate_level2=False, collapse_coarse_n=0)
# the JAX package on the CPU: PCG two-norm, tol 1e-6, b = ones
ITERS24 = {"f64": 10, "f32": 10}


@pytest.fixture(scope="module")
def jax_gs():
    """cfg -> (JAX BoomerAMG, its levels as numpy, its PCG result)."""
    out = {}
    for cfg, kw in CONFIGS.items():
        amg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(**GS, **kw))
        levels = unview(list(amg.levels))
        b = jnp.ones(NX**3, getattr(jnp, kw["dtype"]))
        res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), b,
                      M=lambda r: amg.cycle(r, levels=levels),
                      opts=JaxPCGOptions(tol=1e-6, max_iter=80, two_norm=True))
        out[cfg] = (amg, jax.tree.map(np.asarray, levels), res)
    return out


def _history_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))


@pytest.mark.parametrize("cfg,tol", [("f64", 1e-10), ("f32", 1e-4)])
def test_gs_pcg_matches_jax(jax_gs, cfg, tol):
    """relax 13 / 14 at 24^3 from the port's own setup: the JAX package's
    count and residual history."""
    _, _, ref = jax_gs[cfg]
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    BoomerAMGOptions(**GS, **CONFIGS[cfg]), device="cpu")
    assert all(l.gs_fwd is not None for l in amg.levels[:-1])
    assert amg.levels[-1].gs_fwd is None
    b = torch.ones(NX**3, dtype=amg.levels[0].dinv.dtype)
    A0 = amg.levels[0].A
    res = pcg(lambda x: spmv(A0, x), b, M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=80, two_norm=True))
    assert int(ref.num_iterations) == ITERS24[cfg]
    assert res.converged and res.num_iterations == ITERS24[cfg]
    assert _history_err(res.res_norms.numpy(), ref.res_norms) <= tol


@pytest.mark.parametrize("kw", [
    dict(),
    dict(relax_order=1),
    dict(relax_down=6, relax_up=6, omega=0.8, relax_weight=0.9),
    dict(relax_down=3, relax_up=4, level_omegas=(0.6, 0.9)),
])
def test_cycle_over_carried_levels_matches_jax(kw):
    """The port's V-cycle over the JAX package's frozen levels
    (levels_from_numpy carries the GS schedules, C / F pairs included)
    within 1e-12 of the JAX cycle, from zero and from a given u."""
    opts = dict(GS, dtype="float64", **kw)
    jamg = JaxBoomerAMG(jax_laplacian_7pt(12, 12, 12), JaxOptions(**opts))
    levels = jax.tree.map(np.asarray, unview(list(jamg.levels)))
    amg = BoomerAMG.from_levels(levels_from_numpy(levels, "cpu"),
                                BoomerAMGOptions(**opts), device="cpu")
    if kw.get("relax_order"):
        assert isinstance(amg.levels[0].gs_bwd, tuple)
    rng = np.random.default_rng(11)
    f, u = rng.standard_normal(1728), rng.standard_normal(1728)
    for uu in (None, u):
        ref = np.asarray(jamg.cycle(
            jnp.asarray(f), None if uu is None else jnp.asarray(uu)))
        z = amg.cycle(torch.from_numpy(f),
                      None if uu is None else torch.from_numpy(uu)).numpy()
        assert np.abs(z - ref).max() <= 1e-12 * np.abs(ref).max()


def test_solve_matches_jax_history():
    """BoomerAMG.solve (hypre's solver 0) at 24^3, relax 13 / 14, tol
    1e-6: the JAX package's iteration count and x dtype; the residual
    history within 1e-10 of the JAX one while the residual is above 1e-4
    of its start, and every entry within 1e-14 of the initial residual
    (a cycle's rounding, ~1e-16 relative, grows relative to the shrinking
    residual: 1.3e-10 of the last entry, 1e-6 of the start)."""
    opts = dict(GS, dtype="float64")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(**opts))
    ref = jamg.solve(jnp.ones(NX**3), tol=1e-6, max_iter=60)
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(**opts),
                    device="cpu")
    res = amg.solve(torch.ones(NX**3, dtype=torch.float64), tol=1e-6,
                    max_iter=60)
    assert res.num_iterations == int(ref.num_iterations) == 26
    assert res.converged and res.x.dtype == torch.float64
    a, b = res.res_norms.numpy(), np.asarray(ref.res_norms)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    early = ok & (b >= 1e-4 * b[0])
    assert _history_err(a[early], b[early]) <= 1e-10
    assert np.abs(a[ok] - b[ok]).max() <= 1e-14 * b[0]


def test_default_options_construct_and_solve():
    """BoomerAMGOptions() itself (relax 13 / 14, the lattice options on):
    the port builds it and PCG takes the JAX package's count at 24^3."""
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(),
                    device="cpu")
    b = torch.ones(NX**3, dtype=torch.float64)
    A0 = amg.levels[0].A
    res = pcg(lambda x: spmv(A0, x), b, M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=80, two_norm=True))
    assert res.converged and res.num_iterations == 10


def test_lattice_configuration_with_gs_keeps_the_plain_forms():
    """relax 13 / 14 with lattice_shape: the embedding, relocation and
    collapse gates decline, in the port as in the JAX package, and the
    frozen levels take the same plain forms."""
    opts = dict(SLICE, relax_down=13, relax_up=14, lattice_shape=(NX, NX, NX),
                relocate_min_n2=0, dtype="float64")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(**opts))
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(**opts),
                    device="cpu")
    assert amg._plan_embed() is None and not amg._reloc_cells
    assert len(amg.levels) == len(amg._host_A) == len(jamg.levels)
    names = [type(l.A).__name__ for l in amg.levels]
    assert names == [type(l.A).__name__ for l in unview(list(jamg.levels))]
    n = [l.dinv.shape[0] for l in amg.levels]
    assert n == [A.shape[0] for A in amg._host_A]  # nothing embedded
    assert all(l.gs_fwd is not None for l in amg.levels[:-1])


def test_cycle_launches_count_the_gs_sweeps():
    """One sweep a GS relaxation call and level: 2 a level for 13 / 14,
    4 for SSOR (6), doubled by the C / F halves; no smoothing matvec."""
    A = laplacian_7pt(20, 20, 20)
    for kw, per_level in ((dict(relax_down=13, relax_up=14), 2),
                          (dict(relax_down=6, relax_up=6), 4),
                          (dict(relax_down=13, relax_up=14, relax_order=1), 4)):
        amg = BoomerAMG(A, BoomerAMGOptions(**GS | kw), device="cpu")
        got = amg.cycle_launches()
        assert got["gs_sweep"] == per_level * (len(amg.levels) - 1)
        assert got.get("dia_spmv", 0) == 1  # the fine residual only
