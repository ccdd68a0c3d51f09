"""The port's distributed BoomerAMG (hypre_tpu_torch/parallel/par_amg.py,
par_gs.py) and `entry.dryrun_multichip` against the JAX package's
(tests/test_par_amg.py's cases), the port's shards on
`make_mesh(devices=["cpu"] * S)`, f64.

Held: the sharded cycle within 1e-12 of the JAX package's sharded cycle
and of the serial cycle; PCG on sharded vectors with the JAX package's
count and residual history; the hybrid GS sweeps (relax 3 / 4 / 6 / 13,
and the CF-ordered halves) within 1e-12 of the JAX package's and of a
host model of par_relax.c's hybrid semantics; the dry run's counts at
small sizes equal to the JAX package's at the same shard count
(`DRYRUN_SMALL_JAX`, the hybrid-SSOR leg's residual history too,
recomputed by the slow `jax_count` test, which mirrors the JAX
package's slow hybrid-GS convergence test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jlap7
from hypre_tpu.parallel import make_mesh as jax_mesh
from hypre_tpu.parallel.par_amg import ParAMG as JaxParAMG
from hypre_tpu.solvers.amg import BoomerAMG as JaxAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch.entry import dryrun_multichip
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.parallel import make_mesh
from hypre_tpu_torch.parallel.par_amg import ParAMG
from hypre_tpu_torch.parallel.par_gs import (build_par_gs_schedule,
                                             par_gauss_seidel)
from hypre_tpu_torch.parallel.partition import block_partition
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from torch_threads import one_thread  # noqa: F401

TOL = 1e-12
L1 = dict(coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
          relax_down=18, relax_up=18, embed_level1=False)
# the JAX package's dry-run counts at the test's sizes, 4 shards, f64:
# (a) l1-Jacobi PCG at 24^3 (the serial count too), (b) hybrid SSOR PCG
# at 12^3 (`pytest -m slow tests/test_torch_par_amg.py -k jax_count`)
DRYRUN_SMALL = dict(nx=24, nx_gs=12, nx_setup=8)
DRYRUN_SMALL_JAX = {"a": 12, "b": 6}
# the JAX package's residual history of (b) there
DRYRUN_SMALL_JAX_B_NORMS = (
    28.950257036871335, 0.743978843445889, 0.02873882548814735,
    0.0010650013402514564, 2.8812169591697427e-05, 9.848929150399996e-07,
    3.05142643860526e-08)


def cpu_mesh(S):
    return make_mesh(devices=["cpu"] * S)


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * float(np.abs(b).max())


def both_amg(nx, **kw):
    """(port BoomerAMG on the CPU, JAX BoomerAMG) of the nx^3 Laplacian."""
    return (BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**kw),
                      device="cpu"),
            JaxAMG(jlap7(nx, nx, nx), JaxOptions(**kw)))


def port_cycle(pamg, f):
    return pamg.fine.unpad(pamg.cycle(pamg.fine.pad_vec(f)))


def serial_cycle(amg, f):
    return amg.cycle(torch.from_numpy(f)).numpy()


@pytest.fixture(scope="module")
def problem12():
    """tests/test_par_amg.py's problem: 12^3, ext+i, l1-Jacobi; sharded
    on 8 shards with repl_threshold 400 in both packages."""
    amg, jamg = both_amg(12, **L1)
    return amg, jamg, ParAMG(amg, cpu_mesh(8), repl_threshold=400), \
        JaxParAMG(jamg, jax_mesh(8), repl_threshold=400)


def test_par_cycle_matches_jax_and_serial(problem12):
    amg, jamg, pamg, jpamg = problem12
    assert pamg.split == jpamg.split >= 1
    assert [type(l.A).__name__ for l in pamg.par_levels] == [
        type(l.A).__name__ for l in jpamg.par_levels]
    f = np.random.default_rng(0).standard_normal(12**3)
    z = port_cycle(pamg, f)
    close(z, np.asarray(jpamg.fine.unpad(jpamg.cycle(jpamg.fine.pad_vec(f)))))
    close(z, serial_cycle(amg, f))


def test_par_pcg_matches_jax_sharded_solve(problem12):
    """The l1-Jacobi sharded PCG: the JAX package's sharded count and
    residual history, and the serial count (the .saved invariance)."""
    amg, jamg, pamg, jpamg = problem12
    b = np.ones(12**3)
    res = pcg(pamg.fine.matvec_fn, pamg.fine.pad_vec(b), M=pamg.precond,
              opts=PCGOptions(tol=1e-10, max_iter=60))
    jres = jax_pcg(jpamg.fine.matvec_fn, jpamg.fine.pad_vec(b),
                   M=jpamg.precond, opts=JaxPCGOptions(tol=1e-10, max_iter=60))
    ser = pcg(lambda v: torch.from_numpy(amg._host_A[0] @ v.numpy()),
              torch.from_numpy(b), M=amg.precond,
              opts=PCGOptions(tol=1e-10, max_iter=60))
    its = res.num_iterations
    assert res.converged and its == int(jres.num_iterations) == \
        ser.num_iterations
    close(res.res_norms[: its + 1].numpy(),
          np.asarray(jres.res_norms)[: its + 1], 1e-10)


@pytest.mark.parametrize("opts", [
    dict(relax_down=0, relax_up=0, relax_weight=0.8, num_sweeps=2),
    dict(cycle_type=2),  # W-cycle: the tail's top descends twice
    dict(relax_order=1),  # CF-ordered l1-Jacobi
], ids=["jacobi-w0.8-2sweeps", "W", "cf-order"])
def test_par_amg_honors_smoother_and_cycle_options(opts):
    """tests/test_par_amg.py's options case (10^3, 4 shards): the sharded
    cycle equals the serial one, the port's and the JAX package's."""
    amg, jamg = both_amg(10, **{**L1, **opts})
    f = np.random.default_rng(1).standard_normal(1000)
    z = port_cycle(ParAMG(amg, cpu_mesh(4), repl_threshold=400), f)
    close(z, serial_cycle(amg, f))
    close(z, np.asarray(jamg.cycle(jnp.asarray(f))))


def host_hybrid_gs(Ah, per, S, u, f, w, forward, l1, mask=None):
    """Model of par_relax.c:1050-1086: sequential GS inside each rank's
    diagonal block (masked rows only, with a mask), Jacobi across
    (off-block columns read the sweep-start iterate)."""
    n = Ah.shape[0]
    u = u.copy()
    u0 = u.copy()
    for s in range(S):
        lo, hi = s * per, min((s + 1) * per, n)
        order = range(lo, hi) if forward else range(hi - 1, lo - 1, -1)
        for i in order:
            if mask is not None and not mask[i]:
                continue
            acc = diag = offd_abs = 0.0
            for p in range(Ah.indptr[i], Ah.indptr[i + 1]):
                j, a = Ah.indices[p], Ah.data[p]
                if j == i:
                    diag = a
                inside = lo <= j < hi
                acc += a * (u[j] if inside else u0[j])
                if not inside:
                    offd_abs += abs(a)
            div = (abs(diag) + offd_abs) if l1 else diag
            if l1 and diag < 0:
                div = -div
            if div != 0:
                u[i] += w * (f[i] - acc) / div
    return u


@pytest.mark.parametrize("relax", [3, 4, 6, 13])
def test_par_hybrid_gs_faithful(relax):
    """tests/test_par_amg.py's sweep case (10^3, classical, 4 shards,
    repl_threshold 200): one relaxation call on the finest sharded level
    within 1e-12 of the JAX package's and of the host model."""
    kw = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=relax, relax_up=relax, embed_level1=False)
    amg, jamg = both_amg(10, **kw)
    pamg = ParAMG(amg, cpu_mesh(4), repl_threshold=200)
    jpamg = JaxParAMG(jamg, jax_mesh(4), repl_threshold=200)
    lvl, jlvl = pamg.par_levels[0], jpamg.par_levels[0]
    Ah = amg._host_A[0]
    n = Ah.shape[0]
    rng = np.random.default_rng(3)
    u, f = rng.standard_normal(n), rng.standard_normal(n)
    z = lvl.A.unpad(pamg.smooth(0, relax, lvl.A.pad_vec(u),
                                lvl.A.pad_vec(f), up=False))
    jz = np.asarray(jpamg._smooth_par(jlvl, relax, jlvl.A.pad_vec(u),
                                      jlvl.A.pad_vec(f), up=False))[:n]
    close(z, jz)
    ref = u.copy()
    for fwd in {3: [True], 4: [False], 6: [True, False], 13: [True]}[relax]:
        ref = host_hybrid_gs(Ah, lvl.A.part.rows_per_shard, 4, ref, f,
                             amg.opts.relax_weight, fwd, relax == 13)
    close(z, ref)


def cf_gs_amg(nx=8):
    kw = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=13, relax_up=14, relax_order=1, embed_level1=False)
    return both_amg(nx, **kw)


def test_par_gs_cf_order():
    """relax_order 1 with the hybrid GS family: at one shard the hybrid
    is sequential CF-GS, so the sharded cycle equals the serial cycle
    (the port's and the JAX package's); at four shards the C and F
    half-sweeps equal the host model's masked sweeps."""
    amg, jamg = cf_gs_amg()
    f = np.random.default_rng(3).standard_normal(512)
    pamg1 = ParAMG(amg, cpu_mesh(1), repl_threshold=200)
    assert pamg1.split >= 1
    z1 = port_cycle(pamg1, f)
    close(z1, serial_cycle(amg, f))
    close(z1, np.asarray(jamg.cycle(jnp.asarray(f))))

    pamg4 = ParAMG(amg, cpu_mesh(4), repl_threshold=200)
    lvl = pamg4.par_levels[0]
    Ah = amg._host_A[0]
    per = lvl.A.part.rows_per_shard
    u = np.random.default_rng(4).standard_normal(512)
    cm = amg._cf[0] > 0
    for up, masks in ((False, (cm, ~cm)), (True, (~cm, cm))):
        z = lvl.A.unpad(pamg4.smooth(0, 14 if up else 13, lvl.A.pad_vec(u),
                                     lvl.A.pad_vec(f), up=up))
        ref = u.copy()
        for m in masks:
            ref = host_hybrid_gs(Ah, per, 4, ref, f, 1.0, not up, True, m)
        close(z, ref)


def test_par_gs_empty_trailing_shard():
    """100 rows on 8 shards (shard 7 empty, shard 6 four rows): the
    empty shard has no schedule and the short one sweeps its rows."""
    Ah = laplacian_7pt(10, 10, 1).to_scipy().tocsr()
    part = block_partition(100, 8)
    mesh = cpu_mesh(8)
    sched = build_par_gs_schedule(Ah, part, mesh, "shard", forward=True,
                                  l1=True)
    assert sched.scheds[7] is None and sched.n_local[6:] == [4, 0]
    rng = np.random.default_rng(5)
    u, g = rng.standard_normal(100), rng.standard_normal(100)
    pad = lambda v: tuple(torch.from_numpy(  # noqa: E731
        np.concatenate([v, np.zeros(28)])[s * 16:(s + 1) * 16])
        for s in range(8))
    z = torch.cat(par_gauss_seidel(sched, pad(u), pad(g), 0.9))[:100].numpy()
    # g is the right-hand side after the off-shard part: the model sweeps
    # with every off-shard column read as zero
    blocks = Ah.copy().tolil()
    for i in range(100):
        for j in Ah.indices[Ah.indptr[i]:Ah.indptr[i + 1]]:
            if i // 16 != j // 16:
                blocks[i, j] = 0.0
    l1 = np.asarray(np.abs(Ah).sum(axis=1)).ravel()
    inb = np.asarray(np.abs(blocks.tocsr()).sum(axis=1)).ravel()
    ref = u.copy()
    B = blocks.tocsr()
    for i in range(100):
        acc = B[i].toarray().ravel() @ ref
        d = Ah[i, i]
        ref[i] += 0.9 * (g[i] - acc) / (abs(d) + l1[i] - inb[i])
    close(z, ref)


def test_par_amg_rejects_unsupported_relax():
    amg = BoomerAMG(laplacian_7pt(6, 6, 6), BoomerAMGOptions(
        relax_down=16, relax_up=16), device="cpu")
    with pytest.raises(NotImplementedError, match="sharded"):
        ParAMG(amg, cpu_mesh(2))


def test_replicated_tail_runs_once_on_shard0(problem12, monkeypatch):
    """The deliberate deviation: the JAX package runs the replicated
    tail on every device; the port gathers f onto shard 0's device and
    runs it once a visit (the cycle equal all the same,
    test_par_cycle_matches_jax_and_serial)."""
    amg, jamg, pamg, jpamg = problem12
    calls = []
    run = pamg.tail_amg._run
    monkeypatch.setattr(pamg.tail_amg, "_run",
                        lambda *a: calls.append(a[2].device) or run(*a))
    pamg.cycle(pamg.fine.pad_vec(np.ones(12**3)))
    assert calls == [pamg.mesh.devices[0]]
    assert all(l.dinv.device == pamg.mesh.devices[0]
               for l in pamg.tail_levels)


def counted(monkeypatch):
    """Count the port's kernel-routed calls on the CPU (each is one launch
    on the card): DIA and ELL products, sharded and in the tail, and GS
    sweeps."""
    import hypre_tpu_torch.ops.dia as D
    import hypre_tpu_torch.parallel.par_csr as PC
    import hypre_tpu_torch.parallel.par_dia as PD
    import hypre_tpu_torch.parallel.par_gs as PG
    import hypre_tpu_torch.solvers.amg.boomeramg as B

    calls = {"dia_spmv": 0, "ell_spmv": 0, "gs_sweep": 0}
    for mod, name, key in ((D, "dia_spmv", "dia_spmv"), (PD, "dia_spmv",
                           "dia_spmv"), (D, "ell_spmv", "ell_spmv"),
                           (PC, "ell_spmv", "ell_spmv"),
                           (PG, "gauss_seidel", "gs_sweep"),
                           (B, "gauss_seidel", "gs_sweep")):
        def wrap(*a, _f=getattr(mod, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, wrap)
    return calls


@pytest.mark.parametrize("relax,S", [(18, 8), (6, 4), (13, 3)])
def test_cycle_launches_walks_the_cycle(monkeypatch, relax, S):
    """ParAMG.cycle_launches (chip_smoke.py holds the card's launches to
    it) counts what one cycle from zero runs: on the CPU every call the
    card would launch a kernel for, counted at the wrappers' callers."""
    kw = {**L1, "relax_down": relax, "relax_up": relax}
    if relax == 13:
        kw.update(relax_up=14, relax_order=1, cycle_type=2)
    amg = BoomerAMG(laplacian_7pt(12, 12, 12), BoomerAMGOptions(**kw),
                    device="cpu")
    pamg = ParAMG(amg, cpu_mesh(S), repl_threshold=200)
    f = pamg.fine.pad_vec(np.ones(12**3))
    calls = counted(monkeypatch)
    pamg.cycle(f)
    want = {k: v for k, v in pamg.cycle_launches().items() if v}
    assert {k: v for k, v in calls.items() if v} == want


def test_dryrun_multichip_small_matches_jax():
    """The slice as a whole, 4 shards at small sizes: the JAX package's
    counts (DRYRUN_SMALL_JAX) for the l1-Jacobi and hybrid-SSOR legs,
    the serial count for (a), the setup chain bitwise (it raises
    otherwise)."""
    out = dryrun_multichip(4, device="cpu", log=lambda *_: None,
                           **DRYRUN_SMALL)
    assert out["a"]["fine"] == "ParDIA" and out["a"]["sharded_levels"] >= 2
    assert out["a"]["iterations"] == out["a"]["serial_iterations"] == \
        DRYRUN_SMALL_JAX["a"]
    assert out["b"]["iterations"] == DRYRUN_SMALL_JAX["b"]
    close(out["b"]["res_norms"], DRYRUN_SMALL_JAX_B_NORMS, 1e-10)
    assert len(out["c"]["rows"]) == 3


def jax_dryrun_counts(nx, nx_gs):
    """The JAX package's dry-run legs (a), (b) on 4 shards, f64 (its own
    dry run's code at the given sizes): {leg: (iterations, history)}."""
    mesh = jax_mesh(4)
    out = {}
    for leg, n, kw, repl in (
            ("a", nx, L1, 1500),
            ("b", nx_gs, dict(L1, relax_down=6, relax_up=6, max_levels=3),
             400)):
        A = jlap7(n, n, n)
        jp = JaxParAMG(JaxAMG(A, JaxOptions(**kw)), mesh, repl_threshold=repl)
        res = jax_pcg(jp.fine.matvec_fn,
                      jp.fine.pad_vec(A.to_scipy() @ np.ones(n**3)),
                      M=jp.precond, opts=JaxPCGOptions(tol=1e-8, max_iter=40))
        its = int(res.num_iterations)
        out[leg] = (its, np.asarray(res.res_norms)[: its + 1])
    return out


@pytest.mark.slow  # the JAX package's hybrid-GS shard_map compile, ~50 s
def test_jax_count_dryrun_small():
    """DRYRUN_SMALL_JAX and (b)'s history: the JAX package's legs at the
    test's sizes on 4 shards."""
    out = jax_dryrun_counts(DRYRUN_SMALL["nx"], DRYRUN_SMALL["nx_gs"])
    assert {k: v[0] for k, v in out.items()} == DRYRUN_SMALL_JAX
    close(out["b"][1], DRYRUN_SMALL_JAX_B_NORMS)


@pytest.mark.slow  # ~1 min: the JAX package at 48^3 and 24^3
def test_jax_count_dryrun_card():
    """chip_smoke.py's PAR_JAX: the JAX package's legs at the card's
    sizes (48^3, 24^3) on 4 shards, f64."""
    from torch_family import chip_smoke

    out = jax_dryrun_counts(48, 24)
    assert {k: v[0] for k, v in out.items()} == chip_smoke().PAR_JAX
