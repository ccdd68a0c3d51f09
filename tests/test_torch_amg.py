"""Solve-phase parity of the port with the JAX package at 24^3.

The JAX package builds the hierarchy; `convert.levels_from_numpy`
carries it into the port, so the V-cycle and PCG are compared on the
identical hierarchy, apart from setup.  The last test runs the port's
own setup end to end.  Tolerances: f64 <= 1e-12 for one V-cycle and
<= 1e-9 on the PCG residual history (XLA and torch sum dot products in
another order on the CPU); f32/bf16 <= 1e-4 on the history.
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
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

NX = 24
# JAX package on the CPU, collapse_coarse_n=0, PCG two-norm, tol 1e-6,
# b = ones
ITERS = {"f64": 16, "f32": 15}
SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)
CONFIGS = {
    "f64": dict(dtype="float64"),
    "f32": dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02),
}
PCG_TOL = dict(tol=1e-6, max_iter=80, two_norm=True)


@pytest.fixture(scope="module")
def jax_amg():
    """cfg -> (JAX BoomerAMG, its levels as numpy, JAX PCG result)."""
    out = {}
    for cfg, kw in CONFIGS.items():
        amg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(**kw, **SLICE))
        levels = unview(list(amg.levels))
        b = jnp.ones(NX**3, getattr(jnp, kw["dtype"]))
        res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), b,
                      M=lambda r: amg.cycle(r, levels=levels),
                      opts=JaxPCGOptions(**PCG_TOL))
        out[cfg] = (amg, jax.tree.map(np.asarray, levels), res)
    return out


def carried(jax_levels, cfg, **kw):
    opts = BoomerAMGOptions(**CONFIGS[cfg], **SLICE, **kw)
    return BoomerAMG.from_levels(levels_from_numpy(jax_levels, "cpu"), opts,
                                 device="cpu")


def port_pcg(amg, dtype):
    b = torch.ones(NX**3, dtype=dtype)
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), b, M=amg.precond,
               opts=PCGOptions(**PCG_TOL))


def history_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))


@pytest.mark.parametrize("relax_order", [0, 1])
def test_vcycle_matches_jax_f64(jax_amg, relax_order):
    """One V-cycle on a seeded random vector; relax_order 1 runs the
    C/F-ordered l1-Jacobi sweeps (the levels' cmask)."""
    if relax_order:
        jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX), JaxOptions(
            relax_order=1, **CONFIGS["f64"], **SLICE))
        levels = jax.tree.map(np.asarray, unview(list(jamg.levels)))
    else:
        jamg, levels, _ = jax_amg["f64"]
    amg = carried(levels, "f64", relax_order=relax_order)
    v = np.random.default_rng(11).standard_normal(NX**3)
    ref = np.asarray(jamg.cycle(jnp.asarray(v)))
    z = amg.cycle(torch.from_numpy(v)).numpy()
    assert np.abs(z - ref).max() / np.abs(ref).max() <= 1e-12


@pytest.mark.parametrize("cfg,tol", [("f64", 1e-9), ("f32", 1e-4)])
def test_pcg_matches_jax_on_carried_hierarchy(jax_amg, cfg, tol):
    _, levels, ref = jax_amg[cfg]
    dt = torch.float64 if cfg == "f64" else torch.float32
    dia_spmv_cuda.launches = 0
    res = port_pcg(carried(levels, cfg), dt)
    assert int(ref.num_iterations) == ITERS[cfg]
    assert res.converged and res.num_iterations == ITERS[cfg]
    assert res.res_norms.shape == (PCG_TOL["max_iter"] + 1,)
    assert history_err(res.res_norms.numpy(), ref.res_norms) <= tol
    assert dia_spmv_cuda.launches == 0  # CPU tensors: plain version only


def test_port_setup_end_to_end_matches_jax(jax_amg):
    _, _, ref = jax_amg["f64"]
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    BoomerAMGOptions(**CONFIGS["f64"], **SLICE), device="cpu")
    res = port_pcg(amg, torch.float64)
    assert res.converged and res.num_iterations == ITERS["f64"]
    assert history_err(res.res_norms.numpy(), ref.res_norms) <= 1e-9


def test_levels_from_numpy_layouts(jax_amg):
    """DIA loses the Pallas padding; dtypes (bf16 included) survive."""
    _, levels, _ = jax_amg["f32"]
    ported = levels_from_numpy(levels, "cpu")
    n0 = levels[0].A.num_rows
    assert tuple(ported[0].A.data.shape) == (7, n0)
    assert ported[0].A.data.dtype == torch.float32
    assert ported[1].A.data.dtype == torch.bfloat16
    assert ported[-1].coarse_inv.dtype == torch.float32
    assert np.array_equal(ported[0].cmask.numpy(), levels[0].cmask)


@pytest.mark.parametrize("field,value", [
    ("interp_type", "bogus"), ("smooth_num_levels", -1),
    ("post_interp_type", -1), ("agg_interp_type", 2),
    ("smooth_type", 7),
    ("restrict_type", 3), ("euclid_domains", 0), ("mat_dtype", "float32"),
])
def test_unimplemented_options_raise(field, value):
    kw = dict(SLICE, dtype="float64")
    kw[field] = value
    with pytest.raises(NotImplementedError, match=field):
        BoomerAMG(laplacian_7pt(4, 4, 4), BoomerAMGOptions(**kw), device="cpu")
