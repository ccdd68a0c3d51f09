"""Systems / nodal / GSMG BoomerAMG, the remaining generators and the
relocated forms' offset budgets: the port against the JAX package.

Bitwise: the generators' CSR, create_nodal_A (every norm and diagonal
option, the signed-max tie rule among them), gsmg_strength,
interp_vec_modify, both budget filters, and the systems hierarchies' CF,
P and coarse A (nodal 0 / 1 / 2 / 3 / 4 / 6, a user dof_func, GSMG).
The hypre oracle's PCG pins of tests/test_systems_amg.py hold on the
port.  On the lattice defaults with a budget, the relocation's
decisions (`gates`) are the JAX package's and one cycle agrees within
1e-12.  The new gates: the device setup chain and the device PMIS
decline systems, nodal and GSMG options, as the JAX package's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hypre_tpu.models as jm
from hypre_tpu.ops.dia import \
    parity_offset_budget_filter as jax_parity_offset_budget_filter
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg.interp import \
    interp_vec_modify as jax_interp_vec_modify
from hypre_tpu.solvers.amg.rap import \
    offset_budget_filter as jax_offset_budget_filter
from hypre_tpu.solvers.amg.strength import create_nodal_A as jax_create_nodal_A
from hypre_tpu.solvers.amg.strength import gsmg_strength as jax_gsmg_strength
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.ops.dia import parity_offset_budget_filter
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.interp import interp_vec_modify
from hypre_tpu_torch.solvers.amg.rap import offset_budget_filter
from hypre_tpu_torch.solvers.amg.strength import create_nodal_A, gsmg_strength
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

PLAIN = dict(embed_level1=False, relocate_level2=False, collapse_coarse_n=0)
# the bench protocol on the plain forms, and the hypre oracle's systems
# protocol (tests/test_systems_amg.py:87-113)
SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, **PLAIN)
ORACLE = dict(SLICE, num_functions=2, max_row_sum=1.0, dtype="float64")


def same_csr(a, b):
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    return (a.shape == b.shape and np.array_equal(a.indptr, b.indptr)
            and np.array_equal(a.indices, b.indices)
            and np.array_equal(a.data, b.data))


GENERATORS = {
    "sys2": ("sys_laplacian_7pt", (5, 4, 3, 2), {}),
    "sys3": ("sys_laplacian_7pt", (4, 3, 3, 3), {}),
    "sys4": ("sys_laplacian_7pt", (3, 3, 3, 4), {}),
    **{f"sys2_opt{k}": ("sys_laplacian_7pt", (4, 3, 2, 2), dict(sys_opt=k))
       for k in range(1, 7)},
    **{f"sys3_opt{k}": ("sys_laplacian_7pt", (3, 3, 2, 3), dict(sys_opt=k))
       for k in range(1, 6)},
    "sys2_mtrx": ("sys_laplacian_7pt", (3, 3, 3, 2),
                  dict(mtrx=[[1.0, -0.5], [0.25, 3.0]], cx=2.0)),
    "5pt": ("laplacian_5pt_2d", (7, 5), dict(c=1.5)),
    "9pt": ("laplacian_9pt", (6, 5), {}),
    "9pt_1d": ("laplacian_9pt", (6, 1), {}),
    "rotate": ("rotate_7pt", (7, 6, 30.0, 0.01), {}),
    "vardifconv": ("vardifconv_7pt", (5, 4, 3), dict(eps=0.5)),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_bitwise(name):
    fn, args, kw = GENERATORS[name]
    got = getattr(pm, fn)(*args, **kw).to_scipy()
    want = getattr(jm, fn)(*args, **kw).to_scipy()
    assert same_csr(got, want)


def _tie_matrix():
    """An interleaved 2-function matrix whose blocks hold entries of equal
    magnitude and both signs (create_nodal_A mode 3's tie rule), and
    blocks whose largest entry is negative alone."""
    L = pm.laplacian_7pt(4, 3, 2).to_scipy()
    A = sp.kron(L, np.array([[2.0, -2.0], [1.5, -6.0]]), format="csr")
    A.sort_indices()
    return A


NODAL_MATRICES = {
    "sys2": lambda: pm.sys_laplacian_7pt(4, 4, 3, 2).to_scipy(),
    "sys3_opt4": lambda: pm.sys_laplacian_7pt(3, 3, 3, 3, sys_opt=4).to_scipy(),
    "ties": _tie_matrix,
}


@pytest.mark.parametrize("diag_option", [0, 1, 2])
@pytest.mark.parametrize("option", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("matrix", list(NODAL_MATRICES))
def test_create_nodal_A_bitwise(matrix, option, diag_option):
    A = NODAL_MATRICES[matrix]()
    nf = 3 if matrix.startswith("sys3") else 2
    got = create_nodal_A(A, nf, option, diag_option)
    assert same_csr(got, jax_create_nodal_A(A, nf, option, diag_option))


@pytest.mark.parametrize("dof", [False, True])
def test_gsmg_strength_bitwise(dof):
    A = pm.sys_laplacian_7pt(5, 4, 4, 2).to_scipy()
    dof_func = np.arange(A.shape[0]) % 2 if dof else None
    got = gsmg_strength(A, 3, seed=99, dof_func=dof_func)
    want = jax_gsmg_strength(A, 3, seed=99, dof_func=dof_func)
    assert same_csr(got, want) and got.nnz > 0


@pytest.mark.parametrize("variant", [1, 2])
def test_interp_vec_modify_bitwise(variant):
    """tests/test_amg.py:397's case: constants and linears interpolated
    exactly after the modification, the same P as the JAX package's."""
    nx = 8
    amg = BoomerAMG(pm.laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, **PLAIN), device="cpu")
    P, cf = amg._host_P[0], amg._cf[0]
    xyz = np.stack(np.meshgrid(*[np.arange(nx)] * 3, indexing="ij"),
                   axis=-1).reshape(-1, 3).astype(float)
    V = np.hstack([np.ones((nx**3, 1)), xyz])
    got = interp_vec_modify(P, cf, V, variant=variant)
    assert same_csr(got, jax_interp_vec_modify(P, cf, V, variant=variant))
    E = np.abs(got @ V[cf > 0] - V)
    if variant == 2:
        # exact where a row has as many coarse neighbours as modes
        full = ~(cf > 0) & (np.diff(got.indptr) >= V.shape[1])
        assert full.any() and E[full].max() < 1e-9
    assert E[cf <= 0].max() <= np.abs(P @ V[cf > 0] - V)[cf <= 0].max() + 1e-12


@pytest.fixture(scope="module")
def reloc_plan():
    """The relocation plan of the port's 24^3 lattice hierarchy (level 2
    and 3 relocated with relocate_min_n2=0): the inputs of the budget
    filters as the build meets them."""
    nx = 24
    amg = BoomerAMG(pm.laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx),
        relocate_min_n2=0, dtype="float64"), device="cpu")
    cpos0 = np.flatnonzero(amg._cf[0] > 0).astype(np.int64)
    return amg, amg._plan_reloc(cpos0)


@pytest.mark.parametrize("budget", [4, 9, 40])
@pytest.mark.parametrize("lump", ["diag", "strong"])
def test_offset_budget_filter_bitwise(reloc_plan, lump, budget):
    amg, plan = reloc_plan
    for ent in plan:
        A_k = amg._host_A[ent["k"]]
        got = offset_budget_filter(A_k, ent["rcell"], budget, lump=lump)
        want = jax_offset_budget_filter(A_k, ent["rcell"], budget, lump=lump)
        assert same_csr(got, want), ent["k"]
        # row sums preserved
        np.testing.assert_allclose(np.asarray(got.sum(1)).ravel(),
                                   np.asarray(A_k.sum(1)).ravel(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("budget", [3, 8, 30])
def test_parity_offset_budget_filter_bitwise(reloc_plan, budget):
    _, plan = reloc_plan
    for ent in plan:
        args = (ent["Pf"], ent["rcell"], ent["lat_shape"], ent["factors"],
                budget)
        got = parity_offset_budget_filter(*args)
        assert same_csr(got, jax_parity_offset_budget_filter(*args))


def _jax_setup(A_jax, **kw):
    return JaxBoomerAMG(A_jax, JaxOptions(**kw))


def assert_hierarchies_equal(amg, ref):
    assert len(amg._host_A) == len(ref._host_A) >= 2
    for k in range(len(ref._host_A)):
        assert same_csr(amg._host_A[k], ref._host_A[k]), k
        if k < len(ref._host_A) - 1:
            assert np.array_equal(amg._cf[k], ref._cf[k]), k
            assert same_csr(amg._host_P[k], ref._host_P[k]), k


SYSTEMS = {
    "unknown classical": dict(nodal=0),
    "unknown ext+i": dict(nodal=0, interp_type="ext+i"),
    **{f"nodal {k}": dict(nodal=k) for k in (1, 2, 3, 4, 6)},
    "nodal 1 diag 1": dict(nodal=1, nodal_diag=1),
    "nodal 2 diag 2": dict(nodal=2, nodal_diag=2),
    "nodal 4 diag 1": dict(nodal=4, nodal_diag=1),
    "gsmg": dict(gsmg=1, num_samples=3),
    "gsmg nodal 1": dict(gsmg=1, nodal=1),
    "nodal 2 agg multipass": dict(nodal=2, interp_type="ext+i",
                                  agg_num_levels=1),
    "relax 13/14": dict(nodal=1, relax_down=13, relax_up=14),
}


@pytest.mark.parametrize("cfg", list(SYSTEMS))
def test_systems_setup_bitwise(cfg):
    """CF, P and A_c of every level equal the JAX package's; every
    function of a node shares its CF decision under nodal coarsening."""
    kw = {**ORACLE, **SYSTEMS[cfg]}
    amg = BoomerAMG(pm.sys_laplacian_7pt(10, 10, 10, 2),
                    BoomerAMGOptions(**kw), device="cpu")
    ref = _jax_setup(jm.sys_laplacian_7pt(10, 10, 10, 2), **kw)
    assert_hierarchies_equal(amg, ref)
    if kw.get("nodal") and not kw.get("agg_num_levels"):
        cf = amg._cf[0]
        assert (cf[0::2] == cf[1::2]).all()


def test_user_dof_func_bitwise():
    """A user dof_func (functions in blocks, not interleaved) on a
    3-function system: the port follows it down the hierarchy as the JAX
    package does, and P never couples two functions."""
    nx, nf = 8, 3
    A = pm.sys_laplacian_7pt(nx, nx, nx, nf)
    n = A.shape[0]
    perm = np.argsort(np.arange(n) % nf, kind="stable")  # function-major
    Ap = A.to_scipy()[perm][:, perm].tocsr()
    Ap.sort_indices()
    dof = (np.arange(n) % nf)[perm]
    kw = {**ORACLE, "num_functions": nf, "dof_func": dof,
          "interp_type": "ext+i"}
    amg = BoomerAMG(pm.laplacian_7pt(1).from_scipy(Ap),
                    BoomerAMGOptions(**kw), device="cpu")
    ref = _jax_setup(jm.laplacian_7pt(1).from_scipy(Ap), **kw)
    assert_hierarchies_equal(amg, ref)
    P = amg._host_P[0].tocoo()
    cdof = dof[amg._cf[0] > 0]
    assert (dof[P.row] == cdof[P.col]).all()


def test_dof_func_of_the_wrong_length_raises():
    with pytest.raises(ValueError, match="dof_func"):
        BoomerAMG(pm.sys_laplacian_7pt(3, 3, 3, 2), BoomerAMGOptions(
            **{**ORACLE, "dof_func": np.zeros(5, dtype=int)}), device="cpu")


def _oracle_pcg(amg, n):
    E = amg.levels[0].A
    return pcg(lambda x: spmv(E, x), torch.ones(n, dtype=torch.float64),
               M=amg.precond,
               opts=PCGOptions(tol=1e-8, max_iter=100, two_norm=True))


@pytest.mark.parametrize("nodal,want", [(1, 15), (3, 14), (4, 15), (6, 14)])
def test_nodal_oracle_pins(nodal, want):
    """hypre 2.20.0 serial (`ij -laplacian -n 10 10 10 -sysL 2 -nf 2
    -solver 1 -pmis -interptype 0 -Pmx 4 -rlx 18 -nodal <k> -tol 1e-8`):
    the port's PCG counts (tests/test_systems_amg.py:87-113)."""
    A = pm.sys_laplacian_7pt(10, 10, 10, 2)
    amg = BoomerAMG(A, BoomerAMGOptions(**{**ORACLE, "nodal": nodal}),
                    device="cpu")
    res = _oracle_pcg(amg, A.shape[0])
    assert res.converged and res.num_iterations == want


def test_sysl_opt_6_oracle_pin():
    """-sysL_opt 6 with nodal 2 at 8^3 x 2: 13 PCG iterations, hypre
    2.20.0 serial (tests/test_systems_amg.py:116-142)."""
    A = pm.sys_laplacian_7pt(8, 8, 8, 2, sys_opt=6)
    amg = BoomerAMG(A, BoomerAMGOptions(**{**ORACLE, "nodal": 2}),
                    device="cpu")
    res = _oracle_pcg(amg, A.shape[0])
    assert res.converged and res.num_iterations == 13


def gates(amg):
    """The lattice forms' decisions of a hierarchy (either package)."""
    n0 = amg._host_A[0].shape[0]
    return {"embed_level1": amg.levels[1].dinv.shape[0] == n0,
            "relocated": sorted(getattr(amg, "_reloc_cells", {}) or {}),
            "frozen_levels": len(amg.levels),
            "setup_levels": len(amg._host_A)}


def _lattice(nx, **kw):
    return dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
                relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx),
                dtype="float64", **kw)


def _same_cycle(amg, jamg, n):
    v = np.random.default_rng(1).standard_normal(n)
    ref = np.asarray(jamg.cycle(jnp.asarray(v),
                                levels=unview(list(jamg.levels))))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12


@pytest.mark.parametrize("nx,kw", [
    (24, dict(relocate_min_n2=0, transfer_offset_budget=8)),
    (24, dict(relocate_min_n2=0, transfer_offset_budget=8,
              relocate_offset_budget=16, relocate_lump="strong")),
    pytest.param(48, dict(relocate_offset_budget=24), marks=pytest.mark.slow),
    pytest.param(48, dict(relocate_offset_budget=24, relocate_lump="strong",
                          transfer_offset_budget=16), marks=pytest.mark.slow),
])
def test_budgets_on_the_lattice_defaults_match_jax(nx, kw):
    """The budgets on the lattice defaults: the JAX package's gates
    (relocated levels, collapse) and one cycle within 1e-12.  At 24^3
    no relocated A is above the dense threshold, so only the transfer
    budget acts there; 48^3 relocates a 7,256-row level 2, where the A
    budget acts (slow: the JAX package's build takes ~40 s)."""
    opts = _lattice(nx, **kw)
    amg = BoomerAMG(pm.laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**opts),
                    device="cpu")
    jamg = JaxBoomerAMG(jm.laplacian_7pt(nx, nx, nx), JaxOptions(**opts))
    assert gates(amg) == gates(jamg)
    assert gates(amg)["relocated"]
    _same_cycle(amg, jamg, nx**3)


def test_systems_on_a_lattice_take_the_jax_gates():
    """num_functions 2 with lattice_shape: the fine grid has 2 n
    unknowns, so the relocation declines; the level-1 embedding applies
    (19 fine offsets), as in the JAX package."""
    nx = 16
    opts = dict(_lattice(nx), num_functions=2, nodal=1, max_row_sum=1.0,
                relocate_min_n2=0)
    amg = BoomerAMG(pm.sys_laplacian_7pt(nx, nx, nx, 2),
                    BoomerAMGOptions(**opts), device="cpu")
    jamg = JaxBoomerAMG(jm.sys_laplacian_7pt(nx, nx, nx, 2),
                        JaxOptions(**opts))
    assert gates(amg) == gates(jamg)
    assert gates(amg)["embed_level1"] and not gates(amg)["relocated"]
    _same_cycle(amg, jamg, 2 * nx**3)


@pytest.mark.parametrize("kw", [dict(gsmg=1), dict(nodal=1, num_functions=2),
                                dict(num_functions=2)])
def test_device_setup_declines_systems_and_gsmg(kw):
    """The device chain (device_setup) and the device PMIS
    (device_coarsen) take one function without GSMG only (the JAX
    package's `_fast_eligible` and its PMIS gate): the host setup runs,
    the JAX package's hierarchy bitwise."""
    nx = 12
    nf = kw.get("num_functions", 1)
    A = (pm.sys_laplacian_7pt(nx, nx, nx, nf) if nf > 1
         else pm.laplacian_7pt(nx, nx, nx))
    jA = (jm.sys_laplacian_7pt(nx, nx, nx, nf) if nf > 1
          else jm.laplacian_7pt(nx, nx, nx))
    opts = dict(_lattice(nx), device_setup=True, device_coarsen=True,
                embed_level1=False, relocate_level2=False,
                collapse_coarse_n=0, **kw)
    amg = BoomerAMG(A, BoomerAMGOptions(**opts), device="cpu")
    assert amg._fast is None
    assert not amg._fast_eligible(amg._host_A[0])
    assert amg._device_cf0(amg._host_A[0]) is None
    assert_hierarchies_equal(amg, _jax_setup(jA, **opts))


def test_nongalerkin_filter_on_a_system_matches_jax():
    """The non-Galerkin filter (ngt 0.02, diagonal lumping) on the
    systems hierarchy: both packages build the same hierarchy bitwise,
    and in both its level 2 has rows with a diagonal at or below 0 and
    entries far beyond the fine ones (why chip_smoke.py's systems
    f32/bf16 run has no filter)."""
    kw = {**ORACLE, "nodal": 1, "nongalerkin_tol": 0.02}
    A = pm.sys_laplacian_7pt(24, 24, 24, 2)
    amg = BoomerAMG(A, BoomerAMGOptions(**kw), device="cpu")
    ref = _jax_setup(jm.sys_laplacian_7pt(24, 24, 24, 2), **kw)
    assert_hierarchies_equal(amg, ref)
    A2 = amg._host_A[2]
    assert (A2.diagonal() <= 0).any()
    assert np.abs(A2.data).max() > 1e20 * np.abs(amg._host_A[0].data).max()


def test_f32_bf16_systems_pcg_tracks_jax():
    """f32 vectors and bf16 matrices on the systems hierarchy (nodal 1,
    24^3 x 2): the JAX package's count (17) and residual history within
    1e-3 of the first residual; the cycle within 1e-6 (f32 rounding of two orders of
    summation).  At 96^3 x 2 the histories part below ~3e-5 of the first
    residual and the counts with them (45 against 50, chip_smoke.py's
    SYS96)."""
    import jax

    from hypre_tpu.ops.dia import spmv as jax_spmv
    from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
    from hypre_tpu.solvers.krylov import pcg as jax_pcg

    nx = 24
    kw = {**ORACLE, "nodal": 1, "dtype": "float32", "mat_dtype": "bfloat16"}
    jamg = _jax_setup(jm.sys_laplacian_7pt(nx, nx, nx, 2), **kw)
    levels = unview(list(jamg.levels))
    n = 2 * nx**3
    ref = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(n, jnp.float32),
                  M=jax.jit(lambda r: jamg.cycle(r, levels=levels)),
                  opts=JaxPCGOptions(tol=1e-6, max_iter=200, two_norm=True))
    amg = BoomerAMG(pm.sys_laplacian_7pt(nx, nx, nx, 2),
                    BoomerAMGOptions(**kw), device="cpu")
    E = amg.levels[0].A
    res = pcg(lambda x: spmv(E, x), torch.ones(n, dtype=torch.float32),
              M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=200, two_norm=True))
    assert res.converged and res.num_iterations == int(ref.num_iterations) == 17
    h, h_ref = res.res_norms.numpy(), np.asarray(ref.res_norms)
    ok = ~np.isnan(h_ref)
    assert np.abs(h[ok] - h_ref[ok]).max() / h_ref[0] <= 1e-3
    v = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    z = amg.cycle(torch.from_numpy(v)).numpy()
    z_ref = np.asarray(jamg.cycle(jnp.asarray(v), levels=levels))
    assert np.abs(z - z_ref).max() / np.abs(z_ref).max() <= 1e-6


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_problem(kind, nx):
    """The JAX package's copy of chip_smoke.problem_matrix."""
    if kind == "laplacian":
        return jm.laplacian_7pt(nx, nx, nx), None
    if kind == "difconv":
        return jm.difconv_7pt(nx, nx, nx), None
    A = jm.sys_laplacian_7pt(nx, nx, nx, 2)
    if kind == "sys":
        return A, None
    n = A.shape[0]
    perm = np.argsort(np.arange(n) % 2, kind="stable")
    Ap = A.to_scipy()[perm][:, perm].tocsr()
    Ap.sort_indices()
    return type(A).from_scipy(Ap), (np.arange(n) % 2)[perm]


def _jax_pcg_count(A, opts):
    import jax

    from hypre_tpu.ops.dia import spmv as jax_spmv
    from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
    from hypre_tpu.solvers.krylov import pcg as jax_pcg

    amg = JaxBoomerAMG(A, JaxOptions(**opts))
    levels = unview(list(amg.levels))
    dt = jnp.float64 if opts["dtype"] == "float64" else jnp.float32
    res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(A.shape[0], dt),
                  M=jax.jit(lambda r: amg.cycle(r, levels=levels)),
                  opts=JaxPCGOptions(tol=1e-6, max_iter=200, two_norm=True))
    return amg, res



@pytest.mark.slow
@pytest.mark.parametrize("label", ["(a) nodal 1 f64", "(b) unknown ext+i f64",
                                   "(c) nodal 1 f32/bf16",
                                   "(d) gsmg ext+i f64"])
def test_jax_count_at_96_is_the_chip_pin(label):
    """The JAX package's PCG count at 96^3 (~1 min each on a CPU; the
    systems ones need ~30 GB of host memory): the count chip_smoke.py's
    phase 14 holds the card to (SYS96)."""
    chip_smoke = _chip_smoke()
    kind, kw, want, _ = chip_smoke.SYS96[label]
    if label.startswith("(c)"):
        want = chip_smoke.SYS96_F32_JAX  # the card is held to the port's
    A, _ = _jax_problem(kind, 96)
    _, res = _jax_pcg_count(A, {**SLICE, "dtype": "float64", **kw})
    assert bool(res.converged) and int(res.num_iterations) == want


@pytest.mark.slow
def test_jax_krylov_and_lobpcg_counts_at_96_are_the_chip_pins():
    """The JAX package's counts of phase 14's Krylov family on the 96^3
    convection-diffusion hierarchy (KRYLOV96) and of LOBPCG (LOBPCG96),
    ~5 min on a CPU."""
    import jax

    from hypre_tpu.ops.dia import spmv as jax_spmv
    from hypre_tpu.solvers import krylov as jk
    from hypre_tpu.solvers.eigen import LOBPCGOptions, lobpcg

    chip_smoke = _chip_smoke()
    nx = 96
    A, _ = _jax_problem("difconv", nx)
    amg = JaxBoomerAMG(A, JaxOptions(**{**SLICE, "interp_type": "ext+i",
                                        "dtype": "float64"}))
    levels = unview(list(amg.levels))
    M = jax.jit(lambda r: amg.cycle(r, levels=levels))
    names = {"gmres": "GMRESOptions", "flexgmres": "FlexGMRESOptions",
             "lgmres": "LGMRESOptions", "cogmres": "COGMRESOptions",
             "bicgstab": "BiCGSTABOptions"}
    for label, ((name, kw), want) in chip_smoke.KRYLOV96.items():
        res = getattr(jk, name)(
            lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3), M=M,
            opts=getattr(jk, names[name])(tol=1e-6, max_iter=200, **kw))
        assert bool(res.converged) and int(res.num_iterations) == want, label
    L, _ = _jax_problem("laplacian", nx)
    amg = JaxBoomerAMG(L, JaxOptions(**{**SLICE, "dtype": "float64"}))
    levels = unview(list(amg.levels))
    cyc = jax.jit(lambda r: amg.cycle(r, levels=levels))
    m = chip_smoke.LOBPCG_M
    X0 = np.random.default_rng(chip_smoke.LOBPCG_SEED).standard_normal(
        (nx**3, m))
    res = lobpcg(
        lambda X: jnp.stack([jax_spmv(levels[0].A, X[:, k])
                             for k in range(m)], 1), jnp.asarray(X0),
        T=lambda R: jnp.stack([cyc(R[:, k]) for k in range(m)], 1),
        opts=LOBPCGOptions(tol=1e-6, max_iter=100))
    assert res.converged and res.num_iterations == chip_smoke.LOBPCG96


@pytest.mark.slow
def test_jax_counts_at_24_are_the_chip_pins():
    """The JAX package's counts (and gates) of phase 14's 24^3
    card-vs-CPU runs: SYS24, BUDGET24, CGNR24, LOBPCG24 (~1 min)."""
    import jax

    from hypre_tpu.ops.csr import CSRMatrix as JaxCSRMatrix
    from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
    from hypre_tpu.ops.dia import spmv as jax_spmv
    from hypre_tpu.solvers import krylov as jk
    from hypre_tpu.solvers.eigen import LOBPCGOptions, lobpcg

    chip_smoke = _chip_smoke()
    nx = 24
    for label, (kind, kw, want) in chip_smoke.SYS24.items():
        A, dof = _jax_problem(kind, nx)
        if dof is not None:
            kw = dict(kw, dof_func=dof)
        _, res = _jax_pcg_count(A, {**SLICE, "dtype": "float64", **kw})
        assert bool(res.converged) and int(res.num_iterations) == want, label
    for label, (kw, want) in chip_smoke.BUDGET24.items():
        amg, res = _jax_pcg_count(jm.laplacian_7pt(nx, nx, nx), _lattice(
            nx, relocate_min_n2=0, **kw))
        assert bool(res.converged) and int(res.num_iterations) == want, label
        g = gates(amg)
        assert {"embed_level1": g["embed_level1"],
                "relocated_levels": g["relocated"],
                "collapsed": g["frozen_levels"] < g["setup_levels"],
                "setup_levels": g["setup_levels"]} == chip_smoke.BUDGET24_GATES
    D, _ = _jax_problem("difconv", nx)
    Ds = D.to_scipy()
    E = jax_freeze_auto(D)
    ET = jax_freeze_auto(JaxCSRMatrix.from_scipy(Ds.T.tocsr()))
    amg = JaxBoomerAMG(D, JaxOptions(**{**SLICE, "interp_type": "ext+i",
                                        "dtype": "float64"}))
    levels = unview(list(amg.levels))
    dinv = jnp.asarray(1.0 / Ds.diagonal())
    Ms = {"amg": jax.jit(lambda r: amg.cycle(r, levels=levels)),
          "diag": lambda r: dinv * r}
    for precond, want in chip_smoke.CGNR24.items():
        res = jk.cgnr(lambda x: jax_spmv(E, x), lambda x: jax_spmv(ET, x),
                      jnp.ones(nx**3), M=Ms[precond],
                      opts=jk.CGNROptions(tol=1e-6, max_iter=50))
        assert int(res.num_iterations) == want, precond
    L = jm.laplacian_7pt(nx, nx, nx)
    amg = JaxBoomerAMG(L, JaxOptions(**{**SLICE, "dtype": "float64"}))
    levels = unview(list(amg.levels))
    cyc = jax.jit(lambda r: amg.cycle(r, levels=levels))
    m = chip_smoke.LOBPCG_M
    X0 = np.random.default_rng(chip_smoke.LOBPCG_SEED).standard_normal(
        (nx**3, m))
    res = lobpcg(
        lambda X: jnp.stack([jax_spmv(levels[0].A, X[:, k])
                             for k in range(m)], 1), jnp.asarray(X0),
        T=lambda R: jnp.stack([cyc(R[:, k]) for k in range(m)], 1),
        opts=LOBPCGOptions(tol=1e-6, max_iter=100))
    assert res.converged and res.num_iterations == chip_smoke.LOBPCG24
