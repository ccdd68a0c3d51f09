"""The cycle options of the port against the JAX package: the cycle
state machine (W and F cycles), grid_relax_type / grid_relax_points,
the additive family, seq_threshold, SolveT and the statistics.

* One cycle of each kind over the JAX package's own frozen levels
  (`convert.levels_from_numpy` and `BoomerAMG.from_levels`): within
  1e-12 relative in f64.
* Whole solves with the port's own setup at 8^3-12^3: the JAX package's
  iteration count and its residual history within 1e-10 relative (a
  stationary solve's, where b - A x cancels, also 1e-14 of the first
  residual, as tests/test_torch_gs.py holds it).
* The hypre pins the JAX package holds (tests/test_options.py:386-415,
  tests/test_parity_ij.py:71-83, tests/test_amg.py:317-343).
* `cycle_launches` against the matvecs and sweeps a cycle really makes
  (counted at the dispatch functions, which launch the kernels on the
  card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import difconv_7pt, laplacian_7pt
from hypre_tpu_torch.ops import dia as port_dia
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg import boomeramg as port_boomeramg
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)
CF_POINTS = ((1, -1), (1, -1), (-1, 1), (0,))
CONFIGS = {
    "W": dict(cycle_type=2),
    "F": dict(fcycle=True),
    "W_gs": dict(cycle_type=2, relax_down=13, relax_up=14),
    "additive": dict(additive=0),
    "additive1": dict(additive=1),
    "mult_additive": dict(mult_additive=0),
    "simple": dict(simple=0),
    "grid_points": dict(grid_relax_type=(18, 18, 18, 9),
                        grid_relax_points=CF_POINTS),
    "grid_type_gs": dict(grid_relax_type=(13, 13, 14, 9)),
    "grid_points_gs": dict(grid_relax_type=(13, 13, 14, 9),
                           grid_relax_points=CF_POINTS),
    "seq_threshold": dict(seq_threshold=150),
}
PCG_TOL = dict(tol=1e-8, max_iter=200, two_norm=True)


def history_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))


def assert_solve_history(a, b):
    """A stationary solve's residual history: within 1e-10 relative
    while the residual is above 1e-4 of the first, and within 1e-14 of
    the first everywhere (b - A x cancels as it converges), as
    tests/test_torch_gs.py holds the relax 13 / 14 solve."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    early = ok & (b >= 1e-4 * b[0])
    assert history_err(a[early], b[early]) <= 1e-10
    assert np.abs(a[ok] - b[ok]).max() <= 1e-14 * b[0]


def jax_solve(amg, nx, tol=PCG_TOL):
    levels = unview(list(amg.levels))
    return jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3),
                   M=lambda r: amg.cycle(r, levels=levels),
                   opts=JaxPCGOptions(**tol))


def port_solve(amg, nx, tol=PCG_TOL):
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), torch.ones(nx**3, dtype=torch.float64),
               M=amg.precond, opts=PCGOptions(**tol))


@pytest.mark.parametrize("cfg", ["W", "F", "W_gs", "additive", "additive1",
                                 "mult_additive", "simple", "grid_points",
                                 "grid_points_gs"])
def test_cycle_on_carried_levels(cfg):
    """One cycle of the port over the JAX package's frozen 12^3 levels."""
    nx = 12
    kw = dict(SLICE, **CONFIGS[cfg])
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    levels = jax.tree.map(np.asarray, unview(list(jamg.levels)))
    amg = BoomerAMG.from_levels(levels_from_numpy(levels, "cpu"),
                                BoomerAMGOptions(**kw), device="cpu")
    v = np.random.default_rng(11).standard_normal(nx**3)
    ref = np.asarray(jamg.cycle(jnp.asarray(v)))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12
    u = 0.5 * v
    ref = np.asarray(jamg.cycle(jnp.asarray(v), jnp.asarray(u)))
    z = amg.cycle(torch.from_numpy(v), torch.from_numpy(u)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_pcg_matches_jax(cfg):
    """The port's setup and PCG at 12^3: the JAX package's count and
    residual history, and its statistics."""
    nx = 12
    kw = dict(SLICE, **CONFIGS[cfg])
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    ref, res = jax_solve(jamg, nx), port_solve(amg, nx)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert history_err(res.res_norms.numpy(), ref.res_norms) <= 1e-10
    assert_stats_equal(amg, jamg)


@pytest.mark.parametrize("cfg", ["W", "F", "grid_points", "grid_type_gs",
                                 "seq_threshold"])
def test_solve_matches_jax(cfg):
    """The stationary solve (hypre's solver 0) at 10^3."""
    nx = 10
    kw = dict(SLICE, **CONFIGS[cfg])
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    ref = jamg.solve(jnp.ones(nx**3), tol=1e-8, max_iter=60)
    res = amg.solve(torch.ones(nx**3, dtype=torch.float64), tol=1e-8,
                    max_iter=60)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert_solve_history(res.res_norms.numpy(), ref.res_norms)


def assert_stats_equal(amg, jamg):
    assert amg.num_levels == jamg.num_levels
    assert amg.num_frozen_levels == jamg.num_frozen_levels
    assert amg.grid_complexity() == jamg.grid_complexity()
    assert amg.operator_complexity() == jamg.operator_complexity()
    assert amg.cycle_complexity() == jamg.cycle_complexity()


@pytest.mark.parametrize("kw", [
    dict(SLICE, relax_order=1),
    dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
         relax_down=18, relax_up=18, lattice_shape=(24, 24, 24),
         relocate_min_n2=0),
    dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
         relax_down=18, relax_up=18, lattice_shape=(24, 24, 24),
         device_setup=True, lattice_coeffs=(1.0, 1.0, 1.0)),
], ids=["plain", "lattice_collapsed", "device_setup"])
def test_statistics_match_jax(kw):
    nx = 24
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    assert_stats_equal(amg, jamg)
    if "lattice_shape" in kw:
        assert amg.num_frozen_levels < amg.num_levels  # collapsed
    if kw.get("device_setup"):
        assert amg._fast is not None and jamg._fast is not None


# -- the hypre pins of the JAX package --------------------------------------

@pytest.mark.parametrize("kw,want", [
    (dict(additive=0), (31, 32)),
    (dict(mult_additive=0), (15,)),
    (dict(simple=0), (20,)),
    (dict(mult_additive=0, add_P_max_elmts=4), (19,)),
    (dict(additive=1), (20,)),
], ids=["additive", "mult_additive", "simple", "mult_additive_pmx",
        "additive1"])
def test_additive_oracle_pins(kw, want):
    """hypre 2.20.0 serial `ij -laplacian -n 12 12 12 -solver 1 -pmis
    -interptype 0 -Pmx 4 <variant> -rlx 18 -tol 1e-8`
    (tests/test_options.py:386-415)."""
    nx = 12
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False, **kw), device="cpu")
    r = port_solve(amg, nx)
    assert r.num_iterations in want and float(r.rel_residual_norm) < 1e-8


def test_mult_additive_keeps_the_galerkin_operators():
    """mult_additive replaces the cycle's P by C^ns P; the coarse
    operators stay the Galerkin products of the original P
    (tests/test_options.py:354-360)."""
    A = laplacian_7pt(12, 12, 12)
    plain = BoomerAMG(A, BoomerAMGOptions(**SLICE), device="cpu")
    madd = BoomerAMG(A, BoomerAMGOptions(mult_additive=0, **SLICE),
                     device="cpu")
    P0, Pm = plain._host_P[0], madd._host_P[0]
    assert Pm.nnz != P0.nnz or abs(Pm - P0).max() > 1e-12
    for a, b in zip(plain._host_A, madd._host_A):
        assert (a != b).nnz == 0


def test_w_cycle_oracle_pin():
    """`ij -pmis -Pmx 0 -rlx 0 -xisone -mu 2` at 10^3: 48 iterations,
    average convergence factor 0.677795 (tests/test_parity_ij.py:71-83)."""
    A = laplacian_7pt(10, 10, 10)
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", relax_down=0, relax_up=0,
        P_max_elmts=0, max_row_sum=1.0, cycle_type=2), device="cpu")
    b = torch.from_numpy(A.to_scipy() @ np.ones(1000))
    res = amg.solve(b, tol=1e-8, max_iter=100)
    it = res.num_iterations
    assert it == 48
    norms = res.res_norms.numpy()
    assert (norms[it] / norms[0]) ** (1.0 / it) == pytest.approx(0.677795,
                                                                 abs=1e-6)


def test_solve_transpose():
    """SolveT (tests/test_amg.py:317-343): on a symmetric A it equals
    Solve; on the nonsymmetric convection-diffusion operator it solves
    A^T x = b; both take the JAX package's counts and histories."""
    opts = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
                relax_down=18, relax_up=18, embed_level1=False)
    A = laplacian_7pt(8, 8, 8)
    amg = BoomerAMG(A, BoomerAMGOptions(**opts), device="cpu")
    b = torch.from_numpy(A.to_scipy() @ np.ones(A.shape[0]))
    rs = amg.solve(b, tol=1e-8, max_iter=40)
    rt = amg.solveT(b, tol=1e-8, max_iter=40)
    assert rs.num_iterations == rt.num_iterations
    np.testing.assert_allclose(rt.x.numpy(), rs.x.numpy(), rtol=1e-10)

    An = difconv_7pt(8, 8, 8, ax=6.0, ay=3.0, az=1.0)
    jAn = jax_difconv_7pt(8, 8, 8, ax=6.0, ay=3.0, az=1.0)
    assert (An.to_scipy() != jAn.to_scipy()).nnz == 0
    amg_n = BoomerAMG(An, BoomerAMGOptions(**opts), device="cpu")
    jamg_n = JaxBoomerAMG(jAn, JaxOptions(**opts))
    xt = np.random.default_rng(3).standard_normal(An.shape[0])
    bt = An.to_scipy().T @ xt
    res = amg_n.solveT(torch.from_numpy(bt), tol=1e-9, max_iter=60)
    ref = jamg_n.solveT(jnp.asarray(bt), tol=1e-9, max_iter=60)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert_solve_history(res.res_norms.numpy(), ref.res_norms)
    np.testing.assert_allclose(res.x.numpy(), xt, atol=1e-6)
    v = np.random.default_rng(5).standard_normal(An.shape[0])
    z, zr = amg_n.cycleT(torch.from_numpy(v)).numpy(), np.asarray(
        jamg_n.cycleT(jnp.asarray(v)))
    assert np.abs(z - zr).max() / np.abs(zr).max() <= 1e-12


def test_grid_relax_points_equal_relax_order():
    """The explicit C / F sweep arrays reproduce relax_order 1 bitwise
    (tests/test_options.py:79-111), for l1-Jacobi and hybrid GS."""
    A = laplacian_7pt(8, 8, 8)
    b = torch.ones(512, dtype=torch.float64)
    for rt in ((18, 18), (13, 14)):
        kw = dict(SLICE, relax_down=rt[0], relax_up=rt[1])
        ro = BoomerAMG(A, BoomerAMGOptions(relax_order=1, **kw), device="cpu")
        grp = BoomerAMG(A, BoomerAMGOptions(
            grid_relax_type=(rt[0], rt[0], rt[1], 9),
            grid_relax_points=CF_POINTS, **kw), device="cpu")
        r1 = ro.solve(b, tol=1e-8, max_iter=60)
        r2 = grp.solve(b, tol=1e-8, max_iter=60)
        assert r1.num_iterations == r2.num_iterations
        assert torch.equal(r1.x, r2.x)


def test_gs_points_on_a_level_without_a_cf_split_raise():
    """A GS point sweep needs the level's (C, F) schedule pair; a level
    with a single schedule refuses it, as the JAX package does."""
    amg = BoomerAMG(laplacian_7pt(6, 6, 6), BoomerAMGOptions(
        **dict(SLICE, relax_down=13, relax_up=14)), device="cpu")
    lvl = amg.levels[0]
    u = torch.zeros(216, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="CF split"):
        amg._gs(lvl.gs_fwd, u, u + 1, 1.0, False, points=1)


def test_seq_threshold_nested_coarse():
    """seq_threshold stops the outer setup at n <= 150 and solves there
    with one cycle of a nested BoomerAMG on the same device; PCG takes
    the plain configuration's 15 (tests/test_options.py:418-445)."""
    A = laplacian_7pt(12, 12, 12)
    amg = BoomerAMG(A, BoomerAMGOptions(
        seq_threshold=150, coarsen_type="pmis", interp_type="classical",
        P_max_elmts=4, relax_down=18, relax_up=18, embed_level1=False),
        device="cpu")
    assert amg._host_A[-1].shape[0] > 9
    assert amg._seq_coarse is not None and amg._seq_coarse.num_levels >= 2
    assert amg._seq_coarse.device == amg.device
    assert amg.levels[-1].coarse_inv is None
    r = port_solve(amg, 12)
    assert r.num_iterations == 15 and float(r.rel_residual_norm) < 1e-8


# -- the lattice forms -------------------------------------------------------

LATTICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
               relax_down=18, relax_up=18, lattice_shape=(24, 24, 24),
               relocate_min_n2=0)


@pytest.mark.slow
@pytest.mark.parametrize("kw,jax_kw", [
    (dict(cycle_type=2), {}), (dict(fcycle=True), {}),
    (dict(additive=0), {}),
    # the JAX package's device RAP takes the smoothed P0; its host
    # branch keeps the Galerkin level 1, as the port does either way
    (dict(simple=0), dict(device_rap=False)),
    (dict(mult_additive=0), dict(device_rap=False)),
], ids=["W", "F", "additive", "simple", "mult_additive"])
def test_lattice_cycles_match_jax(kw, jax_kw):
    """24^3 on the lattice forms (level 1 embedded, levels 2-3
    relocated, parity transfers): one cycle within 1e-12 and the JAX
    package's PCG count; the embedded level-1 operator is the Galerkin
    A1."""
    nx = 24
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx),
                        JaxOptions(**LATTICE, **kw, **jax_kw))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**LATTICE, **kw),
                    device="cpu")
    assert amg._reloc_cells and amg.levels[1].A.num_rows == nx**3
    v = np.random.default_rng(1).standard_normal(nx**3)
    ref = np.asarray(jamg.cycle(jnp.asarray(v)))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12
    ref, res = jax_solve(jamg, nx), port_solve(amg, nx)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    cpos0 = np.flatnonzero(amg._cf[0] > 0)
    xc = np.random.default_rng(2).standard_normal(len(cpos0))
    x1 = np.zeros(nx**3)
    x1[cpos0] = xc
    y = spmv(amg.levels[1].A, torch.from_numpy(x1)).numpy()[cpos0]
    want = amg._host_A[1] @ xc
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()


# -- cycle_launches ----------------------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """Count the dispatch calls that launch a kernel on the card: K1
    (ops/dia.py::dia_spmv), the ELL SpMV (ell_spmv) and a GS sweep
    (gauss_seidel)."""
    counts = {"dia_spmv": 0, "ell_spmv": 0, "gs_sweep": 0}

    def wrap(module, attr, key):
        fn = getattr(module, attr)

        def counted_fn(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(module, attr, counted_fn)

    wrap(port_dia, "dia_spmv", "dia_spmv")
    wrap(port_dia, "ell_spmv", "ell_spmv")
    wrap(port_boomeramg, "gauss_seidel", "gs_sweep")
    return counts


@pytest.mark.parametrize("cfg", ["V", "W", "F", "W_gs", "additive",
                                 "additive1", "simple", "grid_points",
                                 "grid_points_gs", "seq_threshold"])
def test_cycle_launches_count_the_cycle(cfg, counted):
    nx = 12
    kw = dict(SLICE, **CONFIGS.get(cfg, {}))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    want = {k: v for k, v in amg.cycle_launches().items() if v}
    for k in counted:
        counted[k] = 0
    amg.cycle(torch.ones(nx**3, dtype=torch.float64))
    assert {k: v for k, v in counted.items() if v} == want


def test_w_and_f_revisit_the_coarse_levels():
    """Per cycle a V-cycle restricts once from each level, a W-cycle
    2^l times from level l, an F-cycle l + 2 times (hypre's fcycle_lev:
    each level, on its way up, descends once more)."""
    nx = 12
    per = {}
    for name, kw in (("V", {}), ("W", CONFIGS["W"]), ("F", CONFIGS["F"])):
        amg = BoomerAMG(laplacian_7pt(nx, nx, nx),
                        BoomerAMGOptions(**SLICE, **kw), device="cpu")
        steps = list(amg._mult_steps(len(amg.levels), True))
        per[name] = [sum(1 for s in steps if s[0] == "restrict" and s[1] == l)
                     for l in range(len(amg.levels) - 1)]
    L = len(per["V"]) + 1
    assert per["V"] == [1] * (L - 1)
    assert per["W"] == [2**l for l in range(L - 1)]
    assert per["F"] == [l + 2 for l in range(L - 1)]


@pytest.mark.parametrize("field,value", [
    ("coarsen_type", "bogus"), ("cycle_type", 0), ("add_rlx", 7),
    ("grid_relax_type", (18, 18, 18, 13)),
    ("grid_relax_points", ((2,), (1,), (1,), (0,))),
])
def test_malformed_cycle_options_raise(field, value):
    kw = dict(SLICE)
    kw[field] = value
    with pytest.raises(NotImplementedError, match=field):
        BoomerAMG(laplacian_7pt(4, 4, 4), BoomerAMGOptions(**kw), device="cpu")



@pytest.mark.parametrize("cfg,transpose", [("W", False), ("F", True),
                                           ("grid_points", True)])
def test_cycle_launches_count_a_solve(cfg, transpose, counted):
    """A stationary solve (or SolveT) makes its cycles from a guess: as
    many as its iterations, each `cycle_launches(from_zero=False)`, and
    one fine-level residual more than iterations."""
    nx = 20
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx),
                    BoomerAMGOptions(**SLICE, **CONFIGS[cfg]), device="cpu")
    assert isinstance(amg.levels[0].A, port_dia.DIAMatrix)
    levels = amg.levels_T if transpose else amg.levels
    for k in counted:
        counted[k] = 0
    b = torch.ones(nx**3, dtype=torch.float64)
    res = (amg.solveT if transpose else amg.solve)(b, tol=1e-8, max_iter=60)
    its = res.num_iterations
    want = {k: its * v for k, v in amg.cycle_launches(
        levels, from_zero=False).items()}
    for k, v in port_dia.kernel_launches(levels[0].A).items():
        want[k] = want.get(k, 0) + (its + 1) * v
    assert res.converged and its > 0
    assert {k: v for k, v in counted.items() if v} == {
        k: v for k, v in want.items() if v}


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_PINS_96 = ["W f64", "W f32/bf16", "F f64", "additive=0",
                "mult_additive=0", "simple=0",
                "grid_relax_points C/F l1-Jacobi",
                "grid_relax_type (13, 13, 14, 9)", "hmis", "rs"]


@pytest.mark.slow
@pytest.mark.parametrize("label", CHIP_PINS_96)
def test_jax_count_at_96_is_the_chip_pin(label):
    """The JAX package's PCG count at 96^3 (~1 min each on the CPU): the
    count chip_smoke.py's phase 12 holds the card to (CYCLES96)."""
    chip_smoke = _chip_smoke()
    kw, want, _ = chip_smoke.CYCLES96[label]
    nx = 96
    opts = dict(SLICE, dtype="float64")
    opts.update(kw)
    amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
    levels = unview(list(amg.levels))
    dt = jnp.float64 if opts["dtype"] == "float64" else jnp.float32
    res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3, dt),
                  M=jax.jit(lambda r: amg.cycle(r, levels=levels)),
                  opts=JaxPCGOptions(tol=1e-6, max_iter=200, two_norm=True))
    assert bool(res.converged) and int(res.num_iterations) == want


@pytest.mark.slow
@pytest.mark.parametrize("label", ["cljp", "falgout", "cgc", "cr",
                                   "strength_abs", "seq_threshold=150",
                                   "solveT"])
def test_jax_count_at_24_is_the_chip_pin(label):
    """The JAX package's counts of phase 12's 24^3 card-vs-CPU runs
    (CYCLES24, SOLVET24)."""
    chip_smoke = _chip_smoke()
    nx = 24
    opts = dict(SLICE, dtype="float64")
    if label == "solveT":
        A = jax_difconv_7pt(nx, nx, nx, ax=6.0, ay=3.0, az=1.0)
        res = JaxBoomerAMG(A, JaxOptions(**opts)).solveT(
            jnp.ones(nx**3), tol=1e-8, max_iter=60)
        assert int(res.num_iterations) == chip_smoke.SOLVET24
        return
    kw, want = chip_smoke.CYCLES24[label]
    opts.update(kw)
    amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
    res = jax_solve(amg, nx, dict(tol=1e-6, max_iter=200, two_norm=True))
    assert bool(res.converged) and int(res.num_iterations) == want
