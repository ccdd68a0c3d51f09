"""The complex smoothers (hypre_tpu_torch/solvers/amg/{schwarz,
parasails,euclid}.py) on the CPU against the JAX package's: Schwarz in
every variant x domain, ParaSails symmetric (FSAI) and not (SPAI), and
Euclid colored and not, each apply / smoothing sweep to 1e-12; BoomerAMG
with smooth_type 6 / 8 / 9 on 2 levels, set up by the port and carried
over from the JAX package (convert.levels_from_numpy): the JAX
package's PCG count and history to 1e-10; and the gates that decline
the lattice forms, the device setup chain and the coarse collapse for
such a hierarchy, in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg import euclid as jax_euclid
from hypre_tpu.solvers.amg import parasails as jax_parasails
from hypre_tpu.solvers.amg import schwarz as jax_schwarz
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import difconv_7pt, laplacian_7pt
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.ops.dia import freeze_auto
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg import euclid, parasails, schwarz
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

N = 8


def _problem(kind):
    if kind == "laplacian":
        return laplacian_7pt(N, N, N), jax_laplacian_7pt(N, N, N)
    return difconv_7pt(N, N, N), jax_difconv_7pt(N, N, N)


def _close(got, ref, tol=1e-12):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("domain", ["rows", "agglomerate"])
@pytest.mark.parametrize("variant", ["ras", "additive", "multiplicative"])
def test_schwarz_matches_jax(variant, domain):
    A, Aj = _problem("difconv")
    opts = dict(variant=variant, domain=domain, block_size=48, overlap=6)
    sw = schwarz.Schwarz(A, schwarz.SchwarzOptions(**opts), device="cpu")
    swj = jax_schwarz.Schwarz(Aj, jax_schwarz.SchwarzOptions(**opts))
    E, Ej = freeze_auto(A, torch.float64, "cpu"), jax_freeze_auto(Aj)
    sw.attach(lambda v: spmv(E, v))
    swj.attach(lambda v: jax_spmv(Ej, v))
    assert np.array_equal(sw.data.idx.numpy(), np.asarray(swj._idx))
    r = np.random.default_rng(1).standard_normal(A.num_rows)
    assert _close(sw.solve(torch.from_numpy(r)), swj.solve(jnp.asarray(r)))


@pytest.mark.parametrize("symmetric", [True, False], ids=["fsai", "spai"])
def test_parasails_matches_jax(symmetric):
    A, Aj = _problem("laplacian" if symmetric else "difconv")
    opts = dict(symmetric=symmetric)
    ps = parasails.ParaSails(A, parasails.ParaSailsOptions(**opts),
                             device="cpu")
    psj = jax_parasails.ParaSails(Aj, jax_parasails.ParaSailsOptions(**opts))
    r = np.random.default_rng(2).standard_normal(A.num_rows)
    assert _close(ps.solve(torch.from_numpy(r)), psj.solve(jnp.asarray(r)))


@pytest.mark.parametrize("colored", [True, False])
def test_euclid_smooth_matches_jax(colored):
    A, Aj = _problem("difconv")
    ed = euclid.build_euclid(A.to_scipy(), num_domains=4, fill_level=1,
                             colored=colored, device="cpu")
    edj = jax_euclid.build_euclid(Aj.to_scipy(), num_domains=4,
                                  fill_level=1, colored=colored)
    assert ed.ncolors == edj.ncolors
    E, Ej = freeze_auto(A, torch.float64, "cpu"), jax_freeze_auto(Aj)
    rng = np.random.default_rng(3)
    u, f = rng.standard_normal(A.num_rows), rng.standard_normal(A.num_rows)
    got = euclid.euclid_smooth(ed, lambda v: spmv(E, v), torch.from_numpy(u),
                               torch.from_numpy(f), 0.9)
    ref = jax_euclid.euclid_smooth(edj, lambda v: jax_spmv(Ej, v),
                                   jnp.asarray(u), jnp.asarray(f), 0.9)
    assert _close(got, ref)


# ---------------------------------------------------------------------------
# BoomerAMG with the complex smoothers on the first two levels
# ---------------------------------------------------------------------------

NX = 12
PCG_KW = dict(tol=1e-8, max_iter=60, two_norm=True)


def _amg_opts(smooth_type, **kw):
    return {**dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
                   relax_down=18, relax_up=18, smooth_type=smooth_type,
                   smooth_num_levels=2), **kw}


@pytest.fixture(scope="module")
def jax_runs():
    """smooth_type -> (JAX numpy-leaf levels, JAX PCG result)."""
    out = {}
    for st in (6, 8, 9):
        jamg = JaxBoomerAMG(jax_laplacian_7pt(NX, NX, NX),
                            JaxOptions(**_amg_opts(st)))
        levels = unview(list(jamg.levels))
        res = jax_pcg(lambda x: jax_spmv(levels[0].A, x), jnp.ones(NX**3),
                      M=lambda r: jamg.cycle(r, levels=levels),
                      opts=JaxPCGOptions(**PCG_KW))
        out[st] = (jax.tree.map(np.asarray, levels), res)
    return out


def _port_pcg(amg):
    A0 = amg.levels[0].A
    return pcg(lambda x: spmv(A0, x), torch.ones(NX**3, dtype=torch.float64),
               M=amg.precond, opts=PCGOptions(**PCG_KW))


def _history_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    return np.max(np.abs(a[ok] - b[ok]) / np.abs(b[ok]))


@pytest.mark.parametrize("smooth_type", [6, 8, 9])
def test_boomeramg_smooth_type_matches_jax(jax_runs, smooth_type):
    _, ref = jax_runs[smooth_type]
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX),
                    BoomerAMGOptions(**_amg_opts(smooth_type)), device="cpu")
    field = {6: "schwarz", 8: "parasails", 9: "euclid"}[smooth_type]
    assert [getattr(l, field) is not None for l in amg.levels] == [
        l < 2 for l in range(amg.num_frozen_levels)]
    res = _port_pcg(amg)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert _history_err(res.res_norms.numpy(), ref.res_norms) <= 1e-10


@pytest.mark.parametrize("smooth_type", [6, 8, 9])
def test_carried_smooth_type_hierarchy_matches_jax(jax_runs, smooth_type):
    """The JAX hierarchy, its complex smoothers included, carried into the
    port, solves to the JAX package's history."""
    levels, ref = jax_runs[smooth_type]
    amg = BoomerAMG.from_levels(levels_from_numpy(levels, "cpu"),
                                BoomerAMGOptions(**_amg_opts(smooth_type)),
                                device="cpu")
    res = _port_pcg(amg)
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    assert _history_err(res.res_norms.numpy(), ref.res_norms) <= 1e-10


def test_smooth_levels_decline_the_lattice_forms():
    """With smooth_num_levels > 0 both packages keep level 1 compact (no
    embedding, so no relocation), skip the device chain and the coarse
    collapse."""
    nx = 20
    kw = _amg_opts(9, lattice_shape=(nx, nx, nx))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                    device="cpu")
    jamg = JaxBoomerAMG(jax_laplacian_7pt(nx, nx, nx), JaxOptions(**kw))
    assert amg._plan_embed() is None and jamg._plan_embed() is None
    n1 = amg._host_A[1].shape[0]
    assert amg.levels[1].A.num_rows == n1 == jamg.levels[1].A.num_rows
    assert not amg._reloc_cells
    assert isinstance(amg.levels[-1].coarse_inv, torch.Tensor)
    assert amg.num_frozen_levels == amg.num_levels == len(jamg.levels)
    ds = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        **_amg_opts(8, lattice_shape=(nx, nx, nx), interp_type="classical",
                    device_setup=True, lattice_coeffs=(1.0, 1.0, 1.0))),
        device="cpu")
    assert ds._fast is None


def test_fsai_keys_past_int32():
    """From 46,341 rows on, J * n overflows scipy's int32 indices: the
    port's FSAI widens the keys first (a deliberate deviation: the JAX
    package's copy reads wrong entries there).  FSAI normalizes G so that
    G A G^T has a unit diagonal; the port's does at 36^3 (46,656 rows),
    the JAX package's does not."""
    nx = 36
    As = laplacian_7pt(nx, nx, nx).to_scipy()
    P = (As != 0).astype(np.float64).tocsr()
    G = parasails._fsai(As, P)
    assert np.abs((G @ As @ G.T).diagonal() - 1.0).max() <= 1e-12
    Gj = jax_parasails.ParaSails._fsai(As, P)
    assert np.abs((Gj @ As @ Gj.T).diagonal() - 1.0).max() > 1e-3
