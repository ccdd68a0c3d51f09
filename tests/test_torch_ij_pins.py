"""The JAX package's numbers that chip_smoke.py's phase 15 holds the
card's ij runs to (IJ96_*), recomputed on the CPU at 96^3 (slow, ~1 min
and a few GB each).  The JAX hierarchies here keep the lattice forms
off (embed_level1, relocate_level2, collapse_coarse_n): they change the
operators only by rounding, and the JAX package's 96^3 lattice build
needs ~50 GB of host memory; the driver's other options are its own."""

import contextlib
import importlib.util
import io
import pathlib

import jax.numpy as jnp
import pytest

from hypre_tpu.models import laplacian_7pt
from hypre_tpu.ops.dia import freeze_auto, spmv
from hypre_tpu.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu.solvers.amg.hybrid import AMGHybrid, AMGHybridOptions
from hypre_tpu.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

N = 96
OFF = dict(embed_level1=False, relocate_level2=False, collapse_coarse_n=0)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.slow
def test_oracle_line_count_and_complexities():
    """`-solver 1 -pmis -interptype 0 -Pmx 4 -rlx 18 -tol 1e-6`: the
    count and the complexity lines as the driver prints them."""
    cs = _chip_smoke()
    A = laplacian_7pt(N, N, N)
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, max_row_sum=1.0, **OFF))
    assert (f"{amg.grid_complexity():.6f}",
            f"{amg.operator_complexity():.6f}") == cs.IJ96_COMPLEXITY
    E = freeze_auto(A)
    res = pcg(lambda x: spmv(E, x), jnp.ones(N**3), M=amg.precond,
              opts=PCGOptions(tol=1e-6, max_iter=100, two_norm=True))
    assert bool(res.converged) and int(res.num_iterations) == cs.IJ96_ITERS


@pytest.mark.slow
def test_hybrid_phase_counts():
    """`-solver 20 -rlx 18`: DS-PCG, then AMG-PCG (ext+i, tol 1e-8)."""
    cs = _chip_smoke()
    h = AMGHybrid(laplacian_7pt(N, N, N), AMGHybridOptions(
        tol=1e-8, amg=BoomerAMGOptions(
            coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
            relax_down=18, relax_up=18, max_row_sum=1.0, **OFF)))
    b = jnp.ones(N**3)
    ds = h._krylov(b, None, lambda r: h._dinv * r, h.opts.dscg_max_iter,
                   h.opts.cf_tol)
    res = h.solve(b)
    assert bool(res.converged)
    assert (int(ds.num_iterations),
            int(res.num_iterations) - int(ds.num_iterations)
            ) == cs.IJ96_HYBRID_ITERS


@pytest.mark.slow
def test_ilu_gmres_count():
    """`-solver 81 -ilu_lfil 1 -k 20 -max_iter 500 -tol 1e-6` through the
    JAX driver itself (solver 81 builds no BoomerAMG)."""
    from hypre_tpu.drivers import ij

    cs = _chip_smoke()
    with contextlib.redirect_stdout(io.StringIO()):
        res = ij.run(cs.IJ96_ILU.split())
    assert bool(res.converged) and int(res.num_iterations) == cs.IJ96_ILU_ITERS
