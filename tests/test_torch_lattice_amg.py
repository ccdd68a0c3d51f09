"""The lattice solve path of the port against the JAX package's, on the
CPU at 24^3 (relocate_min_n2=0, so the relocation engages at this size).

Both packages get the JAX package's own option defaults (embed_level1,
relocate_level2, relocate_tail, collapse_coarse_n=2048), most tests
with device_rap=False (the embedded level-1 values from the host); the
device_rap=True tests (the defaults themselves) and `entry()`'s options
(ext+i, f32/bf16) take them from the device pass of ops/device_rap.py.
Tolerances: the frozen hierarchies agree in formats, offsets, index
arrays (as integers) and DIA / tail / dense values (bitwise, after the
cast to the storage dtype), but the device pass's level-1 operator:
<= 1e-12 relative (f64) / 1 bf16 ulp (tests/test_torch_device_rap.py
finds it bitwise); the collapsed coarse operator, a chain of dense
products summed in another order by XLA and torch, <= 1e-12 relative
(f64) / 1e-4 (f32).  Through `levels_from_numpy` one V-cycle
agrees <= 1e-12 and PCG takes the same iterations with x within 1e-10
(f64).  The JAX side runs its cycle under one jit: eagerly its parity
matvec compiles a program per diagonal offset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.entry import entry_options
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import (DenseMatrix, DIAMatrix, DIAWithTail,
                                 ELLMatrix, GatherOp, ParityInterpOp,
                                 ParityRestrictOp, ScatterOp, spmv)
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda
from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda
from hypre_tpu_torch.ops.tail_kernel import coo_tail_cuda
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

NX = 24
COMMON = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=18, relax_up=18, device_rap=False)
LATTICE = dict(COMMON, lattice_shape=(NX, NX, NX), relocate_min_n2=0)
PLAIN = dict(COMMON, embed_level1=False, relocate_level2=False,
             collapse_coarse_n=0)
CONFIGS = {
    "f64": dict(dtype="float64"),
    "f32": dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02),
}
PCG_TOL = dict(tol=1e-6, max_iter=80, two_norm=True)
# the plain path's counts (tests/test_torch_amg.py): relocation is a
# permutation and the tail and the collapse are exact up to rounding
ITERS = {"f64": 16, "f32": 15}


def _bits(a) -> np.ndarray:
    """Values as numpy, bf16 as 16-bit patterns (torch or numpy input)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_tail(T, J):
    assert (T is None) == (J is None)
    if T is None:
        return
    for name in ("rows_u", "seg", "cols"):
        assert np.array_equal(getattr(T, name).numpy(), np.asarray(getattr(J, name))), name
    assert np.array_equal(_bits(T.vals), _bits(J.vals))


def _close_values(a, b, where):
    """The device RAP's values: <= 1e-12 relative in f64, <= 1 ulp in
    bf16 (bit patterns ordered like the values)."""
    if a.dtype == torch.bfloat16:
        x, y = (np.where(v < 0, -(v & 0x7FFF), v).astype(np.int32)
                for v in (_bits(a).astype(np.int32), _bits(b).astype(np.int32)))
        assert np.abs(x - y).max() <= 1, where
    else:
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), where


def _same_op(T, J, where, values_tol=False):
    """The port's operator T against the JAX package's J (numpy leaves);
    values_tol: DIA values within _close_values, not bitwise."""
    assert type(T).__name__ == type(J).__name__, where
    if T is None:
        return
    if isinstance(T, DIAMatrix):
        assert T.offsets == tuple(int(o) for o in J.offsets), where
        if values_tol:
            _close_values(T.data, J.data[:, :J.num_rows], where)
        else:
            assert np.array_equal(_bits(T.data), _bits(J.data)[:, :J.num_rows]), where
    elif isinstance(T, DIAWithTail):
        _same_op(T.dia, J.dia, where)
        _same_tail(T.tail, J.tail)
    elif isinstance(T, (ParityInterpOp, ParityRestrictOp)):
        assert T.fine_shape == tuple(J.fine_shape) and T.factors == tuple(J.factors)
        assert len(T.mats) == len(J.mats)
        for a, b in zip(T.mats, J.mats):
            _same_op(a, b, where)
        _same_tail(T.tail, J.tail)
    elif isinstance(T, GatherOp):
        assert T.pos.dtype == torch.int32
        assert np.array_equal(T.pos.numpy(), np.asarray(J.pos)), where
        _same_op(T.inner, J.inner, where)
    elif isinstance(T, ScatterOp):
        assert T.n_out == J.n_out and T.pos.dtype == torch.int64
        assert np.array_equal(T.pos.numpy(), np.asarray(J.pos)), where
        _same_op(T.inner, J.inner, where)
    elif isinstance(T, DenseMatrix):
        assert np.array_equal(_bits(T.data), _bits(J.data)[:J.num_rows, :J.num_cols]), where
    elif isinstance(T, ELLMatrix):
        n = T.num_rows
        assert np.array_equal(T.cols.numpy(), np.asarray(J.cols)[:, :n]), where
        assert np.array_equal(_bits(T.data), _bits(J.data)[:, :n]), where
    else:
        raise AssertionError(f"{where}: unexpected {type(T).__name__}")
    assert T.num_rows == J.num_rows, where


def _same_levels(levels, jlevels, inv_tol, device_rap=False):
    """device_rap: level 1's A came from the device pass (values within
    tolerance, the rest bitwise)."""
    assert len(levels) == len(jlevels)
    for k, (T, J) in enumerate(zip(levels, jlevels)):
        for name in ("A", "P", "R"):
            _same_op(getattr(T, name), getattr(J, name), f"L{k} {name}",
                     values_tol=device_rap and (k, name) == (1, "A"))
        for name in ("dinv", "l1inv", "cmask"):
            assert np.array_equal(getattr(T, name).numpy(),
                                  np.asarray(getattr(J, name))), f"L{k} {name}"
    # the coarse solve: only the last level has one
    assert all(l.coarse_inv is None for l in levels[:-1])
    T, J = levels[-1].coarse_inv, jlevels[-1].coarse_inv
    while not isinstance(T, (torch.Tensor, DenseMatrix)):
        assert type(T).__name__ == type(J).__name__
        assert np.array_equal(T.pos.numpy(), np.asarray(J.pos))
        T, J = T.inner, J.inner
    t = (T.data if isinstance(T, DenseMatrix) else T).double().numpy()
    j = np.asarray(J.data if isinstance(T, DenseMatrix) else J, np.float64)
    assert t.shape == j.shape
    assert np.abs(t - j).max() / np.abs(j).max() <= inv_tol


def _jax_setup(cfg, **kw):
    opts = JaxOptions(**{**LATTICE, **CONFIGS[cfg], **kw})
    amg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), opts)
    levels = unview(list(amg.levels))
    return amg, levels, jax.tree.map(np.asarray, levels)


def _port(cfg, base=LATTICE, **kw):
    return BoomerAMG(laplacian_7pt(NX, NX, NX),
                     BoomerAMGOptions(**{**base, **CONFIGS[cfg], **kw}),
                     device="cpu")


def _port_pcg(amg, dtype=torch.float64):
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), torch.ones(NX**3, dtype=dtype),
               M=amg.precond, opts=PCGOptions(**PCG_TOL))


@pytest.fixture(scope="module")
def jax_f64():
    """The JAX package's lattice hierarchy in f64, its levels as numpy,
    and its jitted V-cycle."""
    amg, levels, np_levels = _jax_setup("f64")
    cycle = jax.jit(lambda r: amg.cycle(r, levels=levels))
    return amg, levels, np_levels, cycle


def test_lattice_hierarchy_equals_jax_f64(jax_f64):
    _, _, jlevels, _ = jax_f64
    amg = _port("f64")
    # embedded level 1, parity transfers with tails, a relocated and
    # collapsed level 2
    kinds = [(type(l.A).__name__, type(l.P).__name__) for l in amg.levels]
    assert kinds == [("DIAMatrix", "DIAMatrix"),
                     ("DIAMatrix", "ParityInterpOp"),
                     ("ScatterOp", "NoneType")]
    assert amg.levels[1].P.tail is not None and amg.levels[1].R.tail is not None
    assert isinstance(amg.levels[2].coarse_inv, ScatterOp)
    assert len(amg._host_A) == 6  # the setup hierarchy keeps its depth
    _same_levels(amg.levels, jlevels, 1e-12)


def test_vcycle_on_carried_lattice_hierarchy_matches_jax(jax_f64):
    _, _, jlevels, cycle = jax_f64
    amg = BoomerAMG.from_levels(
        levels_from_numpy(jlevels, "cpu"),
        BoomerAMGOptions(**LATTICE, **CONFIGS["f64"]), device="cpu")
    v = np.random.default_rng(11).standard_normal(NX**3)
    ref = np.asarray(cycle(jnp.asarray(v)))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12
    # and the port's own hierarchy gives the same cycle
    z2 = _port("f64").cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z2 - ref).max() / np.abs(ref).max() <= 1e-12


def test_pcg_on_carried_lattice_hierarchy_matches_jax(jax_f64):
    _, levels, jlevels, cycle = jax_f64
    ref = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(NX**3),
                  M=cycle, opts=JaxPCGOptions(**PCG_TOL))
    amg = BoomerAMG.from_levels(
        levels_from_numpy(jlevels, "cpu"),
        BoomerAMGOptions(**LATTICE, **CONFIGS["f64"]), device="cpu")
    dia_spmv_cuda.launches = flat_take_cuda.launches = coo_tail_cuda.launches = 0
    res = _port_pcg(amg)
    assert int(ref.num_iterations) == ITERS["f64"]
    assert res.converged and res.num_iterations == ITERS["f64"]
    assert np.abs(res.x.numpy() - np.asarray(ref.x)).max() <= 1e-10
    # CPU tensors: plain versions only
    assert (dia_spmv_cuda.launches, flat_take_cuda.launches,
            coo_tail_cuda.launches) == (0, 0, 0)


def test_port_lattice_and_plain_take_the_same_iterations():
    lat, plain = _port_pcg(_port("f64")), _port_pcg(_port("f64", PLAIN))
    assert lat.converged and plain.converged
    assert lat.num_iterations == plain.num_iterations == ITERS["f64"]
    assert np.abs(lat.x.numpy() - plain.x.numpy()).max() <= 1e-9


def test_lattice_hierarchy_equals_jax_f32_bf16():
    """f32 vectors, bf16 matrices, non-Galerkin 0.02: the storage casts
    (f64 -> f32 -> bf16, nearest even) agree bitwise."""
    _, _, jlevels = _jax_setup("f32")
    amg = _port("f32")
    assert amg.levels[1].A.data.dtype == torch.bfloat16
    assert amg.levels[1].P.tail.vals.dtype == torch.bfloat16
    assert amg.levels[0].A.data.dtype == torch.float32
    _same_levels(amg.levels, jlevels, 1e-4)
    res = _port_pcg(amg, torch.float32)
    assert res.converged and abs(res.num_iterations - ITERS["f32"]) <= 1


def test_uncollapsed_lattice_hierarchy_equals_jax():
    """collapse_coarse_n=0 keeps the deeper relocated levels: a second
    parity pair, and compact P / R behind scatter / gather below the
    last relocated level."""
    _, _, jlevels = _jax_setup("f64", collapse_coarse_n=0)
    amg = _port("f64", collapse_coarse_n=0)
    assert len(amg.levels) == 6
    assert isinstance(amg.levels[2].P, ParityInterpOp)
    assert isinstance(amg.levels[3].A, ScatterOp)
    assert isinstance(amg.levels[3].P, ScatterOp)
    assert isinstance(amg.levels[3].R, GatherOp)
    assert isinstance(amg.levels[-1].coarse_inv, torch.Tensor)
    _same_levels(amg.levels, jlevels, 1e-12)
    res = _port_pcg(amg)
    assert res.converged and res.num_iterations == ITERS["f64"]


def test_small_l2_gate_keeps_plain_forms():
    """Without relocate_min_n2=0 level 2 (922 points) is under the gate:
    the relocation must not engage, the embedding and the collapse do,
    in both packages alike."""
    opts = {**COMMON, **CONFIGS["f64"], "lattice_shape": (NX, NX, NX)}
    jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(**opts))
    jlevels = jax.tree.map(np.asarray, unview(list(jamg.levels)))
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(**opts),
                    device="cpu")
    assert not isinstance(amg.levels[1].P, ParityInterpOp)
    assert isinstance(amg.levels[1].P, ScatterOp)
    assert isinstance(amg.levels[1].R, GatherOp)
    assert amg._reloc_cells == {}
    _same_levels(amg.levels, jlevels, 1e-12)
    res = _port_pcg(amg)
    assert res.converged and res.num_iterations == ITERS["f64"]


def test_tailed_hierarchy_same_iterations():
    off = _port("f64", relocate_tail=False)
    on = _port("f64", relocate_tail=True)
    assert off.levels[1].P.tail is None and on.levels[1].P.tail is not None
    r0, r1 = _port_pcg(off), _port_pcg(on)
    assert r0.num_iterations == r1.num_iterations == ITERS["f64"]
    assert np.abs(r0.x.numpy() - r1.x.numpy()).max() <= 1e-9


def test_collapse_matches_uncollapsed():
    """16^3 without the lattice forms above: the dense sub-cycle below
    the first level of at most 1024 points replaces the levels below."""
    nx = 16
    A = laplacian_7pt(nx, nx, nx)
    b = torch.from_numpy(A.to_scipy() @ np.ones(nx**3))
    kw = dict(COMMON, dtype="float64")
    off = BoomerAMG(A, BoomerAMGOptions(**kw, collapse_coarse_n=0), device="cpu")
    on = BoomerAMG(A, BoomerAMGOptions(**kw, collapse_coarse_n=1024), device="cpu")
    assert len(on.levels) < len(off.levels)
    assert isinstance(on.levels[-1].coarse_inv, DenseMatrix)
    assert on.levels[-1].P is None
    sols = [pcg(lambda x, E=m.levels[0].A: spmv(E, x), b, M=m.precond,
                opts=PCGOptions(tol=1e-8, max_iter=100)) for m in (off, on)]
    assert sols[0].num_iterations == sols[1].num_iterations
    assert np.abs(sols[0].x.numpy() - sols[1].x.numpy()).max() <= 1e-9


def test_collapse_with_relocated_lattice():
    off, on = _port("f64", collapse_coarse_n=0), _port("f64")
    assert len(on.levels) < len(off.levels)
    r0, r1 = _port_pcg(off), _port_pcg(on)
    assert r0.num_iterations == r1.num_iterations
    assert np.abs(r0.x.numpy() - r1.x.numpy()).max() <= 1e-9


@pytest.mark.parametrize("kw", [dict(relax_order=1), dict(num_sweeps_down=2),
                                dict(relax_coarse=18)],
                         ids=["cf_relax", "uneven_sweeps", "jacobi_coarse"])
def test_collapse_gated_off(kw):
    """The collapse needs one linear sweep schedule and the direct
    coarse solve: otherwise the full hierarchy is kept."""
    amg = BoomerAMG(laplacian_7pt(10, 10, 10), BoomerAMGOptions(
        **COMMON, dtype="float64", collapse_coarse_n=2048, **kw), device="cpu")
    assert len(amg.levels) == len(amg._host_A)
    assert amg.levels[-1].P is None
    assert not isinstance(amg.levels[-1].coarse_inv, DenseMatrix)


def test_embedding_gated_off_for_chaotic_gs():
    """relax 5 is outside the embedded levels' Jacobi family: plain
    forms (and no relocation without the embedding), as in the JAX
    package."""
    amg = _port("f64", relax_down=5, relax_up=5)
    assert isinstance(amg.levels[0].P, ELLMatrix)
    assert amg._reloc_cells == {}
    jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(
        **{**LATTICE, **CONFIGS["f64"], "relax_down": 5, "relax_up": 5}))
    assert [type(l.A).__name__ for l in amg.levels] == [
        type(l.A).__name__ for l in unview(list(jamg.levels))]


@pytest.mark.parametrize("cfg", ["f64", "f32"])
def test_device_rap_hierarchy_equals_jax(cfg):
    """The JAX package's lattice defaults themselves (device_rap=True):
    level-0 R from the device transpose, level-1 A from the device
    pass; PCG takes the JAX package's count on its own hierarchy."""
    jamg, jlev, jlevels = _jax_setup(cfg, device_rap=True)
    amg = _port(cfg, device_rap=True)
    assert amg._pending_rap is None and amg._host_A1_unf is not None
    kinds = [(type(l.A).__name__, type(l.P).__name__) for l in amg.levels]
    assert kinds == [("DIAMatrix", "DIAMatrix"),
                     ("DIAMatrix", "ParityInterpOp"),
                     ("ScatterOp", "NoneType")]
    _same_levels(amg.levels, jlevels, 1e-12 if cfg == "f64" else 1e-4,
                 device_rap=True)
    jdt = jnp.float64 if cfg == "f64" else jnp.float32
    ref = jax_pcg(lambda x: jax_spmv(jlev[0].A, x), jnp.ones(NX**3, jdt),
                  M=jax.jit(lambda r: jamg.cycle(r, levels=jlev)),
                  opts=JaxPCGOptions(**PCG_TOL))
    res = _port_pcg(amg, torch.float64 if cfg == "f64" else torch.float32)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert abs(res.num_iterations - ITERS[cfg]) <= (cfg == "f32")


def test_entry_options_hierarchy_equals_jax():
    """`entry()`'s options (ext+i, f32/bf16, the lattice defaults with
    the device RAP) on the 24^3 lattice: the embedded level 1 (wider
    than classical's) and a dense level 2, in both packages alike."""
    opts = entry_options()
    assert opts.lattice_shape == (NX, NX, NX)
    jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(
        **{f: getattr(opts, f) for f in ("coarsen_type", "interp_type",
                                         "P_max_elmts", "relax_down",
                                         "relax_up", "lattice_shape",
                                         "dtype", "mat_dtype")}))
    jlevels = jax.tree.map(np.asarray, unview(list(jamg.levels)))
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device="cpu")
    assert [type(l.A).__name__ for l in amg.levels] == [
        "DIAMatrix", "DIAMatrix", "DenseMatrix"]
    assert len(amg.levels[1].A.offsets) == 223
    _same_levels(amg.levels, jlevels, 1e-4, device_rap=True)


@pytest.mark.parametrize("kw,match", [
    (dict(grid_relax_points=((0,), (0,), (0,), (0,))), "grid_relax_points"),
    (dict(relocate_offset_budget=64), "relocate_offset_budget"),
    (dict(transfer_offset_budget=64), "transfer_offset_budget"),
    (dict(device_setup=True), "device_setup"),
    (dict(device_coarsen=True), "device_coarsen"),
    (dict(lattice_coeffs=(1.0, 1.0, 1.0)), "lattice_coeffs"),
])
def test_unported_lattice_options_raise(kw, match):
    opts = BoomerAMGOptions(**{**LATTICE, "dtype": "float64", **kw})
    with pytest.raises(NotImplementedError, match=match):
        BoomerAMG(laplacian_7pt(4, 4, 4), opts, device="cpu")

