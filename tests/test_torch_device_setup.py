"""The level-0 setup chain on the device (hypre_tpu_torch/ops/
device_setup.py, ops/dia.py::device_lattice_dia, the device_setup
hooks of solvers/amg/boomeramg.py) against the JAX package's
(hypre_tpu/ops/device_setup.py and its hooks), on the same inputs.

Tolerances:
  * device_lattice_dia, the classical interpolation (with and without
    truncation) and device_row_stats: bitwise the JAX package's in f64
    and f32; without truncation the f64 interpolation is also bitwise
    the port's host classical_interp;
  * the RAP: the same kept offsets and the same zero pattern (the filter
    decisions); values within 1e-14 relative per entry in f64 and 4 ulp
    in f32.  They are NOT bitwise: at 12^3, 36 of the 98,496 entries
    differ by one ulp in f64 and in f32, each tol.  XLA on the CPU
    evaluates the JAX source's additions in another grouping somewhere
    (contracting either stage's multiply-adds into FMAs moves more
    entries, not fewer); the port keeps the source's order;
  * end to end at 12^3 (the smallest lattice the chain takes), f64 and
    f32 vectors / bf16 matrices / non-Galerkin 0.02: the same level
    types and offsets, level-0 A / P / R, every dinv / l1inv / cmask
    and the deeper levels bitwise, level-1 A within the RAP's
    tolerance, the same PCG count, the f64 residual history within
    1e-10 relative; one V-cycle through the JAX hierarchy carried over
    by levels_from_numpy within 1e-12 of the port's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops import device_setup as jax_ds
from hypre_tpu.ops.csr import CSRMatrix as JaxCSR
from hypre_tpu.ops.dia import DIAMatrix as JaxDIA
from hypre_tpu.ops.dia import csr_to_dia as jax_csr_to_dia
from hypre_tpu.ops.dia import device_lattice_dia as jax_device_lattice_dia
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import (DenseMatrix, DIAMatrix, GatherOp,
                                 ScatterOp, spmv)
from hypre_tpu_torch.ops.csr import CSRMatrix
from hypre_tpu_torch.ops.device_setup import (device_classical_interp,
                                              device_rap, device_row_stats)
from hypre_tpu_torch.ops.dia import csr_to_dia, device_lattice_dia
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.coarsen import pmis_coarsen
from hypre_tpu_torch.solvers.amg.device_coarsen import device_pmis
from hypre_tpu_torch.solvers.amg.interp import classical_interp
from hypre_tpu_torch.solvers.amg.rap import galerkin_rap, nongalerkin_filter
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

NX = 12
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}
CONFIGS = {
    "f64": dict(dtype="float64"),
    "f32": dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02),
}
PCG_TOL = dict(tol=1e-6, max_iter=100, two_norm=True)


def _options(cfg, nx=NX, **kw):
    """bench.py's options with the device chain (classical, P_max_elmts
    4, relax 18, the lattice forms, lattice_coeffs)."""
    return {**dict(device_setup=True, coarsen_type="pmis",
                   interp_type="classical", P_max_elmts=4, relax_down=18,
                   relax_up=18, relocate_level2=True,
                   lattice_shape=(nx, nx, nx),
                   lattice_coeffs=(1.0, 1.0, 1.0)), **CONFIGS[cfg], **kw}


def _embedded_to_csr(data, offsets, rpos, cpos, shape):
    """The compact scipy CSR of embedded DIA rows at lattice positions."""
    d = np.asarray(data)
    rows_l, cols_l, vals_l = [], [], []
    n_lat = d.shape[1]
    for k, off in enumerate(offsets):
        tgt = rpos + int(off)
        pos = np.searchsorted(cpos, np.clip(tgt, 0, None))
        pos_c = np.minimum(pos, max(len(cpos) - 1, 0))
        valid = (tgt >= 0) & (tgt < n_lat) & (cpos[pos_c] == tgt)
        v = d[k][rpos]
        sel = valid & (v != 0)
        rows_l.append(np.flatnonzero(sel))
        cols_l.append(pos_c[sel])
        vals_l.append(v[sel])
    M = sp.csr_matrix((np.concatenate(vals_l),
                       (np.concatenate(rows_l), np.concatenate(cols_l))),
                      shape=shape)
    M.sum_duplicates()
    M.sort_indices()
    return M


@pytest.mark.parametrize("shape,coeffs,dt", [
    ((5, 4, 3), (1.0, 1.0, 1.0), "float64"),
    ((8, 8, 8), (2.0, 3.0, 40.0), "float32"),
    ((12, 12, 12), (1.0, 1.0, 1.0), "float32"),
    ((6, 5, 4), (0.1, 0.2, 0.3), "float64"),
])
def test_device_lattice_dia_bitwise(shape, coeffs, dt):
    """Bitwise csr_to_dia of laplacian_7pt, and the JAX package's table."""
    D = csr_to_dia(laplacian_7pt(*shape, *coeffs), dt, "cpu")
    G = device_lattice_dia(shape, coeffs, dt, "cpu")
    assert G.offsets == D.offsets and G.data.dtype == DTYPES[dt][1]
    assert torch.equal(G.data, D.data)
    J = jax_device_lattice_dia(shape, coeffs, np.dtype(dt))
    assert G.offsets == tuple(int(o) for o in J.offsets)
    np.testing.assert_array_equal(G.data.numpy(),
                                  np.asarray(J.data)[:, :G.num_rows])
    # not the full 7-point stencil: the caller converts A instead
    assert device_lattice_dia((1, 4, 4), coeffs, dt, "cpu") is None
    assert device_lattice_dia(shape, (1.0, 0.0, 1.0), dt, "cpu") is None


@pytest.fixture(scope="module")
def lattice():
    """The 12^3 Laplacian: host CSR, strength, host CF, and its f64 / f32
    DIA tables in both packages."""
    A = laplacian_7pt(NX, NX, NX).to_scipy().tocsr()
    A.sort_indices()
    S = strength_matrix(A, 0.25, 0.9)
    tables = {dt: (csr_to_dia(CSRMatrix.from_scipy(A), dt, "cpu"),
                   jax_csr_to_dia(JaxCSR.from_scipy(A), dtype=np.dtype(dt)))
              for dt in DTYPES}
    return A, S, pmis_coarsen(S), tables


def _interp(lattice, dt, max_elmts):
    """(port P, port rowmax, JAX P, JAX rowmax) on the same CF."""
    _, _, cf, tables = lattice
    D, Dj = tables[dt]
    cf_d = device_pmis(D.data, D.offsets, D.num_rows)
    P, rm = device_classical_interp(D.data, cf_d, offsets=D.offsets,
                                    max_elmts=max_elmts)
    Pj, rmj = jax_ds.device_classical_interp(
        Dj.data, jnp.asarray(cf, jnp.int8), offsets=Dj.offsets,
        max_elmts=max_elmts)
    return P, rm, np.asarray(Pj), np.asarray(rmj)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("max_elmts", [0, 4])
def test_device_interp_bitwise(lattice, dt, max_elmts):
    A, S, cf, tables = lattice
    P, rm, Pj, rmj = _interp(lattice, dt, max_elmts)
    n = A.shape[0]
    assert P.dtype == DTYPES[dt][1] and tuple(P.shape) == (7, n)
    np.testing.assert_array_equal(P.numpy(), Pj)
    np.testing.assert_array_equal(rm.numpy(), rmj)
    if max_elmts or dt != "float64":
        return
    # untruncated f64: bitwise the port's host interpolation
    P_h = classical_interp(A, S, cf)
    cpos = np.flatnonzero(cf > 0)
    P_d = _embedded_to_csr(P.numpy(), tables[dt][0].offsets, np.arange(n),
                           cpos, P_h.shape)
    np.testing.assert_array_equal(P_d.indptr, P_h.indptr)
    np.testing.assert_array_equal(P_d.indices, P_h.indices)
    np.testing.assert_array_equal(P_d.data, P_h.data)


def _ulps32(a, b):
    """|a - b| in float32 ulps: the bit patterns as ordered integers."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("dt,tol", [("float64", 0.0), ("float64", 0.02),
                                    ("float32", 0.02)])
def test_device_rap_matches_jax(lattice, dt, tol):
    A, _, cf, tables = lattice
    D, Dj = tables[dt]
    n = A.shape[0]
    P, rm, _, _ = _interp(lattice, dt, 4)
    keep = np.flatnonzero(rm.numpy() > 0)
    offs = tuple(D.offsets[k] for k in keep)
    P_dia = DIAMatrix(data=P[torch.from_numpy(keep)], offsets=offs,
                      num_rows=n, num_cols=n)
    out, kept = device_rap(P_dia, D, tol)
    outj, keptj = jax_ds.device_rap(
        JaxDIA(data=jnp.asarray(P_dia.data.numpy()), offsets=offs,
               num_rows=n, num_cols=n), Dj, tol)
    outj = np.asarray(outj)[:, :n]
    o = out.numpy()
    assert kept == tuple(int(k) for k in keptj) and o.shape == outj.shape
    np.testing.assert_array_equal(o == 0, outj == 0)  # the filter's decisions
    if dt == "float64":
        nz = outj != 0
        assert (np.abs(o - outj)[nz] / np.abs(outj[nz])).max() <= 1e-14
        # and the host Galerkin product of the same P (the JAX test's check)
        cpos = np.flatnonzero(cf > 0)
        P_csr = _embedded_to_csr(P_dia.data.numpy(), offs, np.arange(n),
                                 cpos, (n, len(cpos)))
        ref = galerkin_rap(A, P_csr)
        if tol > 0:
            ref = nongalerkin_filter(ref, tol)
        A1 = _embedded_to_csr(o, kept, cpos, cpos, ref.shape)
        assert A1.nnz == ref.nnz and abs(A1 - ref).max() < 1e-12
    else:
        assert _ulps32(o, outj).max() <= 4


@pytest.mark.parametrize("dt", list(DTYPES))
def test_device_row_stats(dt):
    A = laplacian_7pt(8, 8, 8).to_scipy()
    D = csr_to_dia(CSRMatrix.from_scipy(A), dt, "cpu")
    dinv, l1inv = device_row_stats(D.data, offsets=D.offsets)
    dj, lj = jax_ds.device_row_stats(
        jax_csr_to_dia(JaxCSR.from_scipy(A), dtype=np.dtype(dt)).data,
        offsets=D.offsets)
    np.testing.assert_array_equal(dinv.numpy(), np.asarray(dj)[:512])
    np.testing.assert_array_equal(l1inv.numpy(), np.asarray(lj)[:512])
    np.testing.assert_allclose(dinv.numpy(), 1.0 / A.diagonal(), rtol=1e-6)
    np.testing.assert_allclose(
        l1inv.numpy(), 1.0 / np.asarray(abs(A).sum(axis=1)).ravel(),
        rtol=1e-6)


# -- end to end at 12^3 ------------------------------------------------------

@pytest.fixture(scope="module")
def jax_hierarchies():
    """{cfg: (JAX BoomerAMG, its levels, the levels as numpy, its PCG
    result with b = ones)} for the device chain's options."""
    out = {}
    for cfg in CONFIGS:
        amg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX),
                           JaxOptions(**_options(cfg)))
        assert amg._fast is not None
        levels = unview(list(amg.levels))
        dt = jnp.float64 if cfg == "f64" else jnp.float32
        res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(NX**3, dt),
                      M=jax.jit(lambda r: amg.cycle(r, levels=levels)),
                      opts=JaxPCGOptions(**PCG_TOL))
        out[cfg] = (amg, levels, jax.tree.map(np.asarray, levels), res)
    return out


def _close(a, b, rel, where):
    """max |a - b| <= rel * max |b| (rel 0: equal values, -0 == 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, where
    assert np.abs(a - b).max(initial=0) <= rel * np.abs(b).max(initial=0), where


def _same(t, j, rel, where):
    """The port's level leaf t against the JAX package's j: the same
    form, offsets and positions; values within rel (None: not compared)."""
    if isinstance(t, torch.Tensor):
        t, j = t.double(), np.asarray(j)
    else:
        assert type(t).__name__ == type(j).__name__, where
        if t is None:
            return
        if isinstance(t, (ScatterOp, GatherOp)):
            np.testing.assert_array_equal(t.pos.numpy(), np.asarray(j.pos))
            return _same(t.inner, j.inner, rel, where)
        if isinstance(t, DIAMatrix):
            assert t.offsets == tuple(int(o) for o in j.offsets), where
            t, j = t.data.double(), np.asarray(j.data)[:, :t.num_rows]
        else:
            assert isinstance(t, DenseMatrix), where
            t, j = t.data.double(), np.asarray(j.data)
    if rel is not None:
        _close(t.numpy(), j.astype(np.float64), rel, where)


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_fast_path_end_to_end(jax_hierarchies, cfg):
    """Level 0 equal to the JAX package's; level 1's A within the RAP's
    tolerance (f64 1e-14 relative, in bf16 one ulp); in f64 everything
    below within 1e-13 (the host continues from level-1 A's ulps).  In
    f32 those ulps can flip a non-Galerkin or truncation decision of the
    host setup below level 1, so there only the forms are compared."""
    jamg, _, jlevels, ref = jax_hierarchies[cfg]
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(**_options(cfg)),
                    device="cpu")
    assert amg._fast is not None and amg._fast["D0"] is None
    assert [type(l.A).__name__ for l in amg.levels] == [
        "DIAMatrix", "DIAMatrix", "DenseMatrix"]
    assert [a.shape for a in amg._host_A] == [a.shape for a in jamg._host_A]
    deep = 1e-13 if cfg == "f64" else None
    for k, (T, J) in enumerate(zip(amg.levels, jlevels)):
        for name in ("A", "P", "R", "dinv", "l1inv", "cmask", "coarse_inv"):
            rel = (0.0 if k == 0 or name == "cmask"
                   else (1e-14 if cfg == "f64" else 2.0**-8)
                   if (k, name) == (1, "A") else deep)
            _same(getattr(T, name), getattr(J, name), rel, f"L{k} {name}")
    A0 = amg.levels[0].A
    dt = torch.float64 if cfg == "f64" else torch.float32
    res = pcg(lambda x: spmv(A0, x), torch.ones(NX**3, dtype=dt),
              M=amg.precond, opts=PCGOptions(**PCG_TOL))
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    if cfg == "f64":
        its = res.num_iterations
        h = res.res_norms[:its + 1].numpy()
        hj = np.asarray(ref.res_norms)[:its + 1]
        assert np.abs(h - hj).max() <= 1e-10 * np.abs(hj).max()


def test_host_P_materialization(jax_hierarchies):
    """host_P(0) makes the chain's level-0 P a host CSR: the JAX
    package's, bitwise; C rows are the identity."""
    jamg = jax_hierarchies["f64"][0]
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    BoomerAMGOptions(**_options("f64")), device="cpu")
    assert amg._host_P[0] is None
    P0, J0 = amg.host_P(0), jamg.host_P(0)
    assert amg.host_P(0) is P0 and amg.host_P(1) is amg._host_P[1]
    assert P0.shape == J0.shape == (NX**3, amg._host_A[1].shape[0])
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(P0, name), getattr(J0, name))
    cidx = np.flatnonzero(amg._cf[0] > 0)
    np.testing.assert_allclose(np.asarray(P0[cidx].sum(axis=1)).ravel(), 1.0)


def test_levels_from_numpy_cycle(jax_hierarchies):
    """The JAX device-setup hierarchy carried over: one V-cycle equals
    the port's own hierarchy's within 1e-12 (level-1 A differs by the
    RAP's ulps)."""
    _, _, jlevels, _ = jax_hierarchies["f64"]
    opts = BoomerAMGOptions(**_options("f64"))
    carried = BoomerAMG.from_levels(levels_from_numpy(jlevels, "cpu"), opts,
                                    device="cpu")
    own = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device="cpu")
    v = torch.from_numpy(np.random.default_rng(7).standard_normal(NX**3))
    z, z_own = carried.cycle(v).numpy(), own.cycle(v).numpy()
    assert np.abs(z - z_own).max() <= 1e-12 * np.abs(z_own).max()


@pytest.mark.parametrize("kw", [dict(interp_type="ext+i"),
                                dict(relax_down=13, relax_up=14),
                                dict(lattice_shape=(NX, NX, NX - 1))])
def test_ineligible_options_take_the_host_setup(kw):
    """Where the JAX package's gate declines the chain, the port builds
    the host-setup hierarchy, as if device_setup were off."""
    opts = {**_options("f64"), **kw}
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), BoomerAMGOptions(**opts),
                    device="cpu")
    ref = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    BoomerAMGOptions(**{**opts, "device_setup": False}),
                    device="cpu")
    assert amg._fast is None
    assert [a.shape for a in amg._host_A] == [a.shape for a in ref._host_A]
    for a, b in zip(amg._host_A, ref._host_A):
        assert abs(a - b).max() == 0.0


@pytest.mark.slow
@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_jax_count_at_96_is_the_chip_pin(cfg):
    """The JAX package's PCG count with the chain on bench.py's 96^3
    options (about 3 min each on the CPU): the count chip_smoke.py holds
    the card to (DS96_F64 / DS96_F32)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    nx = 96
    amg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx),
                       JaxOptions(**_options(cfg, nx)))
    assert amg._fast is not None
    levels = unview(list(amg.levels))
    dt = jnp.float64 if cfg == "f64" else jnp.float32
    res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(nx**3, dt),
                  M=jax.jit(lambda r: amg.cycle(r, levels=levels)),
                  opts=JaxPCGOptions(**PCG_TOL))
    want = chip_smoke.DS96_F64 if cfg == "f64" else chip_smoke.DS96_F32
    assert bool(res.converged) and int(res.num_iterations) == want
