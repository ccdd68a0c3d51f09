"""Aggressive coarsening of the port against the JAX package: the
multipass form (agg_interp_type 4: a second PMIS / HMIS round on the
S S + 2 S graph, multipass interpolation) and the two-stage form
(agg_interp_type 1: P1 P2 through the intermediate Galerkin operator),
num_paths and the aggressive truncation.

* Every level's CF marker, P and coarse operator bitwise, and the
  statistics equal.
* PCG at 10^3: the JAX package's count and residual history within
  1e-10 relative.
* The hypre oracle's 20^3 sizes [8000, 492, 129]
  (tests/test_multipass.py) and the complexity trade of
  tests/test_amg.py:153.
* The gates: the device setup chain declines aggressive coarsening, and
  the level-1 embedding takes the JAX package's decision (it declines a
  multipass P0 whose level 1 needs more than max_embedded_offsets).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.models import laplacian_27pt as jax_laplacian_27pt
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.models import laplacian_7pt, laplacian_27pt
from hypre_tpu_torch.ops import dia as port_dia
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg import boomeramg as port_boomeramg
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

SLICE = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)
AGG = {
    "multipass": dict(agg_num_levels=1),
    "two_stage": dict(agg_num_levels=1, agg_interp_type=1),
    "hmis": dict(coarsen_type="hmis", agg_num_levels=1),
    "hmis_two_stage": dict(coarsen_type="hmis", agg_num_levels=1,
                           agg_interp_type=1),
    "rs": dict(coarsen_type="rs", agg_num_levels=1),
    "num_paths2": dict(agg_num_levels=1, num_paths=2),
    "agg_trunc": dict(agg_num_levels=1, agg_P_max_elmts=4,
                      agg_trunc_factor=0.1),
    "two_levels": dict(agg_num_levels=2),
    "two_stage_trunc": dict(agg_num_levels=2, agg_interp_type=1,
                            agg_P_max_elmts=4),
    "mfem": dict(coarsen_type="hmis", agg_num_levels=1, relax_down=8,
                 relax_up=8),
}
PROBLEMS = {"7pt": (laplacian_7pt, jax_laplacian_7pt),
            "27pt": (laplacian_27pt, jax_laplacian_27pt)}
PCG_TOL = dict(tol=1e-8, max_iter=200, two_norm=True)


def same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


def assert_hierarchies_equal(amg, ref):
    assert len(amg._host_A) == len(ref._host_A) >= 2
    for k in range(len(ref._host_A)):
        assert same_csr(amg._host_A[k], ref._host_A[k]), k
        if k < len(ref._host_A) - 1:
            assert np.array_equal(amg._cf[k], ref._cf[k]), k
            assert same_csr(amg._host_P[k], ref._host_P[k]), k


def assert_stats_equal(amg, jamg):
    assert amg.num_levels == jamg.num_levels
    assert amg.num_frozen_levels == jamg.num_frozen_levels
    assert amg.grid_complexity() == jamg.grid_complexity()
    assert amg.operator_complexity() == jamg.operator_complexity()
    assert amg.cycle_complexity() == jamg.cycle_complexity()


def jax_solve(amg, nx, tol=PCG_TOL):
    levels = unview(list(amg.levels))
    return jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3),
                   M=lambda r: amg.cycle(r, levels=levels),
                   opts=JaxPCGOptions(**tol))


def port_solve(amg, nx, tol=PCG_TOL):
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), torch.ones(nx**3, dtype=torch.float64),
               M=amg.precond, opts=PCGOptions(**tol))


def history_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))


@pytest.mark.parametrize("problem,nx", [("7pt", 12), ("27pt", 8)])
@pytest.mark.parametrize("cfg", list(AGG))
def test_agg_setup_bitwise(cfg, problem, nx):
    """CF, P and A_c of every level, and the statistics, equal the JAX
    package's; the aggressive level coarsens harder than the plain one."""
    port, jax = PROBLEMS[problem]
    kw = dict(SLICE, **AGG[cfg])
    amg = BoomerAMG(port(nx, nx, nx), BoomerAMGOptions(**kw), device="cpu")
    ref = JaxBoomerAMG(jax(nx, nx, nx), JaxOptions(**kw))
    assert_hierarchies_equal(amg, ref)
    assert_stats_equal(amg, ref)
    plain = BoomerAMG(port(nx, nx, nx), BoomerAMGOptions(**dict(
        kw, agg_num_levels=0)), device="cpu")
    assert amg._host_A[1].shape[0] < plain._host_A[1].shape[0]


@pytest.mark.parametrize("cfg", ["multipass", "two_stage", "hmis",
                                 "num_paths2", "agg_trunc", "mfem"])
def test_agg_pcg_matches_jax(cfg):
    """PCG at 10^3: the JAX package's count and residual history."""
    nx = 10
    kw = dict(SLICE, **AGG[cfg])
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    ref, res = jax_solve(jamg, nx), port_solve(amg, nx)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert history_err(res.res_norms.numpy(), ref.res_norms) <= 1e-10


def test_agg_multipass_matches_oracle_closely():
    """`ij -n 20 20 20 -pmis -interptype 6 -agg_nl 1`: levels [8000,
    492, 129, ...], grid complexity 1.080500, operator complexity
    1.249515, 44 iterations (tests/test_multipass.py); the port's
    stationary solve takes the JAX package's count and history."""
    nx = 20
    opts = dict(coarsen_type="pmis", interp_type="ext+i", agg_num_levels=1,
                relax_down=13, relax_up=14, embed_level1=False)
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**opts),
                    device="cpu")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
    sizes = [a.shape[0] for a in amg._host_A]
    assert sizes[:3] == [8000, 492, 129]
    assert abs(amg.grid_complexity() - 1.080500) < 0.005
    assert abs(amg.operator_complexity() - 1.249515) < 0.06
    assert_hierarchies_equal(amg, jamg)
    b = laplacian_7pt(nx, nx, nx).to_scipy() @ np.ones(nx**3)
    res = amg.solve(torch.from_numpy(b), tol=1e-8, max_iter=100)
    ref = jamg.solve(jnp.asarray(b), tol=1e-8, max_iter=100)
    assert res.converged and res.num_iterations <= 44
    assert res.num_iterations == int(ref.num_iterations)
    a, r = res.res_norms.numpy(), np.asarray(ref.res_norms)
    ok = ~np.isnan(r)
    early = ok & (r >= 1e-4 * r[0])
    assert np.max(np.abs(a[early] - r[early]) / r[early]) <= 1e-10
    assert np.abs(a[ok] - r[ok]).max() <= 1e-14 * r[0]


def test_aggressive_lowers_the_operator_complexity():
    """tests/test_amg.py:153: one aggressive level costs much less
    operator complexity and still converges (with the JAX package's
    count), on the library's lattice defaults."""
    nx = 12
    base = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
                relax_down=18, relax_up=18)
    plain = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**base),
                      device="cpu")
    agg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        **base, agg_num_levels=1), device="cpu")
    assert agg.operator_complexity() < plain.operator_complexity() * 0.75
    assert agg.num_levels <= plain.num_levels
    jagg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(
        **base, agg_num_levels=1))
    res, ref = port_solve(agg, nx), jax_solve(jagg, nx)
    assert res.converged and res.num_iterations == int(ref.num_iterations)


def gates(amg):
    """The lattice forms' decisions of a hierarchy (either package)."""
    n0 = amg._host_A[0].shape[0]
    return {"embed_level1": amg.levels[1].dinv.shape[0] == n0,
            "relocated": sorted(getattr(amg, "_reloc_cells", {}) or {}),
            "frozen_levels": len(amg.levels),
            "setup_levels": len(amg._host_A)}


@pytest.mark.parametrize("max_off", [
    512, pytest.param(1024, marks=pytest.mark.slow)])  # 1024: ~25 s
def test_agg_lattice_gates_match_jax(max_off):
    """24^3 on the lattice defaults with one aggressive level: the
    embedding declines the multipass level 1 (547 embedded offsets)
    under the default budget of 512 and takes it under 1024, as the
    JAX package decides; one cycle within 1e-12 and the same PCG
    count."""
    nx = 24
    kw = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
              relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx),
              agg_num_levels=1, max_embedded_offsets=max_off)
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    assert gates(amg) == gates(jamg)
    assert gates(amg)["embed_level1"] == (max_off > 547)
    assert amg.num_frozen_levels < amg.num_levels  # collapsed
    v = np.random.default_rng(1).standard_normal(nx**3)
    ref = np.asarray(jamg.cycle(jnp.asarray(v)))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12
    tol = dict(tol=1e-6, max_iter=200, two_norm=True)
    res, rref = port_solve(amg, nx, tol), jax_solve(jamg, nx, tol)
    assert res.converged and res.num_iterations == int(rref.num_iterations)


def test_device_setup_declines_aggressive_coarsening():
    """The device chain runs only the plain level 0; with
    agg_num_levels it stays off, as in the JAX package, and the host
    builds the same hierarchy as without device_setup."""
    nx = 12
    kw = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx),
              lattice_coeffs=(1.0, 1.0, 1.0), agg_num_levels=1,
              embed_level1=False, relocate_level2=False, collapse_coarse_n=0)
    for extra in (dict(), dict(agg_num_levels=0, post_interp_type=1),
                  dict(agg_num_levels=0, restrict_type=1)):
        opts = dict(kw, device_setup=True, **extra)
        amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**opts),
                        device="cpu")
        jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
        assert amg._fast is None and jamg._fast is None
        assert_hierarchies_equal(amg, jamg)


@pytest.fixture
def counted(monkeypatch):
    """Count the dispatch calls that launch a kernel on the card."""
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


@pytest.mark.parametrize("cfg", ["multipass", "two_stage", "mfem"])
def test_cycle_launches_count_an_aggressive_cycle(cfg, counted):
    """`cycle_launches` on an aggressive hierarchy (20^3: level 0 DIA,
    the rest ELL or dense) is what a cycle launches."""
    nx = 20
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        **dict(SLICE, **AGG[cfg])), device="cpu")
    assert isinstance(amg.levels[0].A, port_dia.DIAMatrix)
    want = {k: v for k, v in amg.cycle_launches().items() if v}
    for k in counted:
        counted[k] = 0
    amg.cycle(torch.ones(nx**3, dtype=torch.float64))
    assert {k: v for k, v in counted.items() if v} == want
    assert want["ell_spmv"] > 0


# -- check_options -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(agg_num_levels=2, agg_P_max_elmts=3, agg_trunc_factor=0.1,
         agg_interp_type=1, num_paths=2),
    dict(interp_type="standard-sep", post_interp_type=2,
         jacobi_trunc_threshold=0.05),
    dict(restrict_type=2, filter_threshold_r=0.1, air_neumann_degree=1),
], ids=["agg", "interp", "air"])
def test_new_options_accepted(kw):
    amg = BoomerAMG(laplacian_7pt(6, 6, 6), BoomerAMGOptions(
        **dict(SLICE, **kw)), device="cpu")
    assert amg.num_levels >= 2


@pytest.mark.parametrize("field,value", [
    ("agg_interp_type", 2), ("agg_interp_type", 5), ("restrict_type", 3),
    ("num_paths", 0), ("interp_type", "bogus"), ("nodal", 5),
    ("smooth_type", 7), ("smooth_type", 5), ("num_functions", 0),
    ("relocate_lump", "neighbours"), ("transfer_offset_budget", -8),
])
def test_other_options_still_raise(field, value):
    kw = dict(SLICE)
    kw[field] = value
    with pytest.raises(NotImplementedError, match=field):
        BoomerAMG(laplacian_7pt(4, 4, 4), BoomerAMGOptions(**kw), device="cpu")


# -- the chip pins -----------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
@pytest.mark.parametrize("label", ["(a) multipass f64", "(b) multipass f32/bf16",
                                   "(c) two-stage f64", "(d) MFEM default f64"])
def test_jax_count_at_96_is_the_chip_pin(label):
    """The JAX package's PCG count at 96^3 (~1 min each on a CPU): the
    count chip_smoke.py's phase 13 holds the card to (AGG96)."""
    chip_smoke = _chip_smoke()
    kw, want, _ = chip_smoke.AGG96[label]
    nx = 96
    opts = dict(SLICE, dtype="float64")
    opts.update(kw)
    amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
    levels = unview(list(amg.levels))
    dt = jnp.float64 if opts["dtype"] == "float64" else jnp.float32
    import jax

    res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3, dt),
                  M=jax.jit(lambda r: amg.cycle(r, levels=levels)),
                  opts=JaxPCGOptions(tol=1e-6, max_iter=200, two_norm=True))
    assert bool(res.converged) and int(res.num_iterations) == want


@pytest.mark.slow
def test_jax_counts_at_24_are_the_chip_pins():
    """The JAX package's counts and gates of phase 13's 24^3 card-vs-CPU
    runs (INTERP24, AGG_LATTICE24)."""
    chip_smoke = _chip_smoke()
    nx = 24
    tol = dict(tol=1e-6, max_iter=200, two_norm=True)
    for label, (kw, want) in chip_smoke.INTERP24.items():
        opts = {**SLICE, "interp_type": "classical", "dtype": "float64", **kw}
        amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
        res = jax_solve(amg, nx, tol)
        assert bool(res.converged) and int(res.num_iterations) == want, label
    kw, want, want_gates = chip_smoke.AGG_LATTICE24
    amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(
        coarsen_type="pmis", P_max_elmts=4, relax_down=18, relax_up=18,
        lattice_shape=(nx, nx, nx), dtype="float64", **kw))
    res = jax_solve(amg, nx, tol)
    assert bool(res.converged) and int(res.num_iterations) == want
    g = gates(amg)
    assert {"embed_level1": g["embed_level1"],
            "relocated_levels": g["relocated"],
            "collapsed": g["frozen_levels"] < g["setup_levels"],
            "setup_levels": g["setup_levels"]} == want_gates


@pytest.mark.slow
def test_jax_counts_of_air_are_the_chip_pins():
    """The JAX package's stationary-solve counts of phase 13's AIR runs
    (AIR24) on difconv_7pt(24, 24, 24, ax=6, ay=3, az=1)."""
    chip_smoke = _chip_smoke()
    from hypre_tpu.models import difconv_7pt as jax_difconv_7pt

    nx = 24
    A = jax_difconv_7pt(nx, nx, nx, ax=6.0, ay=3.0, az=1.0)
    for label, (kw, want, transpose) in chip_smoke.AIR24.items():
        amg = JaxBoomerAMG(A, JaxOptions(**{
            **SLICE, "interp_type": "classical", **chip_smoke.AIR24_OPTIONS,
            **kw}))
        res = (amg.solveT if transpose else amg.solve)(
            jnp.ones(nx**3), tol=1e-8, max_iter=80)
        assert bool(res.converged) and int(res.num_iterations) == want, label
