"""The port's grid-spec (.in) path — `sstruct/infile.py`,
`sstruct/assemble.py`, the driver's `-in` mode and FAC-AMR
(`solvers/sstruct_ls/fac_amr.py`) — on the CPU against the JAX
package's, on the texts of chip_smoke.py::SSTRUCT_INFILES (written by
hand; together they use every keyword `read_infile` parses).

  * parse: the same ProblemData, with and without -r refinement;
  * assembly: the same variable boxes, S blocks and U, bitwise; the
    cosine right-hand side bitwise (its var-number-as-vartype quirk
    included);
  * every driver id on every text against the JAX driver's numbers
    (INFILE_RUNS, pinned: count, final residual within 1e-12, ||x||_2
    within 1e-12); cheap lines also against the JAX driver run live (x
    elementwise within 1e-12 of max |x|); the slow tier reruns the JAX
    driver on every pin;
  * FAC-AMR: the setup (per-part stencils after the driver zeroing and
    the AMR RAP, the covered masks, the U couplings, the coarsest
    SysPFMG's hierarchy) bitwise, the solve's count and history.
"""

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import sstruct as jax_driver
from hypre_tpu.solvers.sstruct_ls.fac_amr import FACAMROptions as JFACOpts
from hypre_tpu.solvers.sstruct_ls.fac_amr import FACAMRSolver as JFAC
from hypre_tpu.sstruct.assemble import AssembledSystem as JAssembled
from hypre_tpu.sstruct.infile import map_refinement as jmap
from hypre_tpu.sstruct.infile import read_infile as jread
from hypre_tpu_torch.drivers import sstruct as port_driver
from hypre_tpu_torch.solvers.sstruct_ls.fac_amr import (FACAMROptions,
                                                        FACAMRSolver)
from hypre_tpu_torch.sstruct.assemble import AssembledSystem
from hypre_tpu_torch.sstruct.infile import map_refinement, read_infile
from torch_threads import one_thread  # noqa: F401

CPU = torch.device("cpu")

# "text -solver id [flags]" -> (iterations, final relative residual,
# ||x||_2) of the JAX driver
INFILE_RUNS = {
    'neighbor -solver 18': (25, 5.995635984315484e-07, 17.653748073620427),
    'neighbor -solver 20': (8, 7.940007046728873e-07, 17.65374749079365),
    'neighbor -solver 11': (10, 2.364422400958833e-07, 17.6537478689402),
    'neighbor -solver 19': (25, 7.889239347760032e-07, 17.653748096571107),
    'neighbor -solver 1': (24, 8.363566255163151e-07, 17.653737347801126),
    'neighbor -solver 0': (17, 6.52803981845201e-07, 17.65374456545146),
    'neighbor -solver 8': (54, 8.108115681386188e-07, 17.653728332629342),
    'neighbor -solver 10': (9, 3.7152980749107024e-07, 17.6537471198739),
    'cell_node -solver 18': (17, 5.555841036353615e-07, 35.21518770850513),
    'cell_node -solver 20': (7, 3.9937569911289693e-07, 35.21518847702668),
    'cell_node -solver 11': (8, 9.230350244051102e-07, 35.21518729690031),
    'cell_node -solver 0': (13, 4.597677392544027e-07, 35.21517600846693),
    'cell_node -solver 1': (18, 4.941274444442845e-07, 35.215176039644604),
    'cell_node -solver 8': (29, 8.900083159099709e-07, 35.21515121281049),
    'cell_node -solver 10': (8, 3.4544963012253766e-07, 35.21518731950147),
    'cell_node -solver 19': (17, 8.636015932669669e-07, 35.21518760432616),
    'fac -solver 18': (21, 5.519022884149208e-07, 28.11015834403828),
    'fac -solver 20': (8, 4.0081391270023203e-07, 28.1101579304848),
    'fac -solver 11': (9, 2.591281790968918e-07, 28.110158238086054),
    'fac -solver 99': (10, 7.645475896248211e-07, 18.064889835313355),
    'fac -solver 50': (10, 7.645475896248211e-07, 18.064889835313355),
    'neighbor -solver 18 -r 2 2 2': (41, 7.460616605947171e-07, 62.37931156379816),
    'cell_node -solver 11 -r 2 2 2': (10, 6.169188535340457e-07, 47.30975440841279),
    'fac -solver 99 -r 1 2 1': (14, 6.608991167706454e-07, 26.530048200410345),
    'cell_node -solver 19 -b 1 2 1 -rhsone': (18, 7.553871961939641e-07, 17.36345872457377),
}
LIVE = ['neighbor -solver 18', 'cell_node -solver 19', 'fac -solver 99',
        'fac -solver 20']
KEYWORDS = ("GridCreate", "GridSetExtents", "GridSetVariables",
            "GridSetPeriodic", "GridSetNeighborPart", "StencilCreate",
            "StencilSetEntry", "GraphSetStencil", "GraphAddEntries",
            "MatrixSetValues", "MatrixAddToValues", "FacParts")


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TEXTS = _chip_smoke().SSTRUCT_INFILES


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{name: path} of the texts written out."""
    d = tmp_path_factory.mktemp("sstruct_in")
    out = {}
    for name, text in TEXTS.items():
        (d / f"{name}.in").write_text(text)
        out[name] = str(d / f"{name}.in")
    return out


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().ravel()
    if isinstance(x, dict):
        return np.concatenate([flat(x[k]) for k in sorted(x)])
    if isinstance(x, (tuple, list)):
        return np.concatenate([flat(v) for v in x])
    return np.asarray(x).ravel()


def argv(corpus, key):
    name, rest = key.split(" ", 1)
    return ["-in", corpus[name]] + rest.split()


def test_texts_use_every_keyword():
    for kw in KEYWORDS:
        assert any(f"\n{kw}:" in "\n" + t for t in TEXTS.values()), kw
    # a non-CELL variable type in use: NODE and XFACE
    assert "[0 1]" in TEXTS["cell_node"] and "[0 2]" in TEXTS["cell_node"]


REFINE = [None, [2, 2, 2], [1, 3, 2]]


@pytest.mark.parametrize("r", REFINE, ids=str)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_parse_matches_jax(corpus, name, r):
    dj, dp = jread(corpus[name]), read_infile(corpus[name])
    if r:
        jmap(dj, r)
        map_refinement(dp, r)
    assert repr(dp).replace("hypre_tpu_torch.", "hypre_tpu.") == repr(dj)


@pytest.mark.parametrize("r", REFINE[:2], ids=str)
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_assembly_is_the_jax_one(corpus, name, r):
    dj, dp = jread(corpus[name]), read_infile(corpus[name])
    if r:
        jmap(dj, r)
        map_refinement(dp, r)
    sj, sp_ = JAssembled(dj), AssembledSystem(dp, device=CPU)
    assert sp_.var_boxes == sj.var_boxes
    assert sp_.grid.offsets() == sj.grid.offsets()
    assert list(sp_.A.smats) == list(sj.A.smats)
    for k, m in sj.A.smats.items():
        p = sp_.A.smats[k]
        assert p.offsets == tuple(tuple(o) for o in m.offsets)
        assert np.array_equal(p.data.numpy(), np.asarray(m.data))
    Uj, U = sj.A.u_host, sp_.A.u_host
    for a, b in ((U.indptr, Uj.indptr), (U.indices, Uj.indices),
                 (U.data, Uj.data)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_cosine_rhs_is_the_jax_one(corpus, name, monkeypatch):
    """The JAX driver's right-hand side, caught at its PCG call, against
    the port's `b`, bitwise (cell_node's XFACE variable reads the NODE
    box: indices outside its own box are skipped)."""
    import hypre_tpu.solvers.krylov as jk

    seen = {}

    def catch(A, b, **kw):
        seen["b"] = np.asarray(b)
        raise StopIteration

    monkeypatch.setattr(jk, "pcg", catch)
    with pytest.raises(StopIteration), contextlib.redirect_stdout(
            io.StringIO()):
        jax_driver.run(["-in", corpus[name], "-solver", "19"])
    with contextlib.redirect_stdout(io.StringIO()):
        res = port_driver.run(["-in", corpus[name], "-solver", "19",
                               "-max_iter", "1"], device="cpu")
    assert np.array_equal(res.b.numpy(), seen["b"])


@pytest.mark.parametrize("key", sorted(INFILE_RUNS))
def test_line_matches_jax_driver(corpus, key):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = port_driver.run(argv(corpus, key), device="cpu")
    iters, rel, xnorm = INFILE_RUNS[key]
    assert res.num_iterations == iters
    assert abs(float(res.rel_residual_norm) - rel) <= 1e-12
    assert abs(np.linalg.norm(flat(res.x)) - xnorm) <= 1e-12 * xnorm
    assert out.getvalue().splitlines()[-2] == f"Iterations = {iters}"


@pytest.mark.parametrize("key", LIVE)
def test_line_matches_live_jax_driver(corpus, key):
    with contextlib.redirect_stdout(io.StringIO()):
        res = port_driver.run(argv(corpus, key), device="cpu")
        jres = jax_driver.run(argv(corpus, key))
    assert res.num_iterations == int(jres.num_iterations)
    xj = flat(jres.x)
    assert np.abs(flat(res.x) - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.parametrize("r", [None, [1, 2, 1]], ids=str)
def test_fac_amr_setup_is_the_jax_one(corpus, r):
    dj, dp = jread(corpus["fac"]), read_infile(corpus["fac"])
    if r:
        jmap(dj, r)
        map_refinement(dp, r)
    fj = JFAC(dj, JFACOpts(tol=1e-6, max_iter=20))
    fp = FACAMRSolver(dp, FACAMROptions(tol=1e-6, max_iter=20), device=CPU)
    assert fp.rfactors == fj.rfactors and fp.U == fj.U
    for p in range(fj.nparts):
        assert fp.offsets[p] == fj.offsets[p]
        for a, b in ((fp.coef, fj.coef), (fp.rap, fj.rap),
                     (fp.covered, fj.covered)):
            assert np.array_equal(a[p], b[p])
    cj, cp = fj.csolver, fp.csolver
    assert len(cp.levels) == len(cj.levels) > 2
    assert cp.coarse_maxiter == cj.coarse_maxiter
    for (A, cdir, act, P), (Aj, cdirj, actj, Pj) in zip(cp.levels, cj.levels):
        assert (cdir, act, A.ilo, A.offsets) == (cdirj, actj, Aj.ilo,
                                                 Aj.offsets)
        assert np.array_equal(A.coef, Aj.coef)
        assert (P is None) == (Pj is None)
        if P is not None:
            assert (P != Pj).nnz == 0


def test_fac_amr_solve_matches_jax(corpus):
    dj, dp = jread(corpus["fac"]), read_infile(corpus["fac"])
    rng = np.random.default_rng(11)
    fj = JFAC(dj, JFACOpts(tol=1e-9, max_iter=30))
    fp = FACAMRSolver(dp, FACAMROptions(tol=1e-9, max_iter=30), device=CPU)
    b = {p: rng.standard_normal(fj.shape[p]) for p in range(fj.nparts)}
    x0 = {p: rng.standard_normal(fj.shape[p]) for p in range(fj.nparts)}
    rj = fj.solve(b_parts=b, x_parts=x0)
    rp = fp.solve(b_parts=b, x_parts={p: torch.from_numpy(v)
                                      for p, v in x0.items()})
    assert rp.num_iterations == rj.num_iterations > 5
    assert rp.converged == rj.converged
    hj = rj.res_norms
    assert np.abs(rp.res_norms.numpy() - hj).max() <= 1e-12 * hj[0]
    xj = flat(rj.x)
    assert np.abs(flat(rp.x) - xj).max() <= 1e-12 * np.abs(xj).max()


@pytest.mark.slow
@pytest.mark.parametrize("key", sorted(INFILE_RUNS))
def test_jax_driver_matches_its_pin(corpus, key):
    with contextlib.redirect_stdout(io.StringIO()):
        res = jax_driver.run(argv(corpus, key))
    iters, rel, xnorm = INFILE_RUNS[key]
    assert int(res.num_iterations) == iters
    assert abs(float(res.rel_residual_norm) - rel) <= 1e-12
    assert abs(np.linalg.norm(flat(res.x)) - xnorm) <= 1e-12 * xnorm
