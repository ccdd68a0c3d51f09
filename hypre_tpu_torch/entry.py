"""The flagship single-device step and the sharded dry run
(counterparts of the JAX package's `__graft_entry__.entry` and
`__graft_entry__.dryrun_multichip`).

    step, (b,) = entry(device="cuda")
    x, rel_residual_norm = step(b)
    counts = dryrun_multichip(4)      # 4 shards on the CUDA devices

BoomerAMG-preconditioned PCG on the 24^3 7-point Poisson problem with
the JAX package's flagship options: PMIS, extended+i interpolation
(P_max_elmts 4), l1-Jacobi (relax 18) down and up, the lattice forms on
the 24^3 lattice with the embedding's level-1 values from the device
RAP (the defaults embed_level1 and device_rap), float32 vectors and
bfloat16 matrices.  `step` runs one block of at most 10 PCG iterations
to tol 1e-8 from a zero guess.  The setup runs when `entry` is called;
the hierarchy lives on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import laplacian_7pt
from .ops import spmv
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .solvers.krylov import PCGOptions, pcg

NX = 24


def entry_options() -> BoomerAMGOptions:
    """The options `__graft_entry__.entry` passes, on the NX^3 lattice."""
    return BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18, lattice_shape=(NX, NX, NX),
        dtype="float32", mat_dtype="bfloat16")


def entry(device="cuda"):
    """(step, (b,)): set up the hierarchy on `device` and return the
    solve step with its example right-hand side b = A @ ones (float32,
    on `device`).  `step.amg` is the BoomerAMG hierarchy."""
    n = NX**3
    A = laplacian_7pt(NX, NX, NX)
    amg = BoomerAMG(A, entry_options(), device=device)
    E = amg.levels[0].A

    def step(b):
        res = pcg(lambda x: spmv(E, x), b, M=amg.precond,
                  opts=PCGOptions(tol=1e-8, max_iter=10))
        return res.x, res.rel_residual_norm

    step.amg = amg  # the hierarchy, for inspection
    b = torch.from_numpy((A.to_scipy() @ np.ones(n)).astype(np.float32))
    return step, (b.to(device),)


def dryrun_multichip(n_devices: int, devices=None, device="cuda", *,
                     nx: int = 48, nx_gs: int = 24, nx_setup: int = 12,
                     log=print) -> dict:
    """The sharded solver end to end on n_devices shards, float64
    (`__graft_entry__.dryrun_multichip`'s three legs):

    (a) nx^3 (48^3 = 110,592 rows), PMIS + ext+i (P_max 4), l1-Jacobi,
        embed_level1=False, repl_threshold 1500: the fine operator
        assembled from per-shard row blocks (no global matrix) equals the
        sharded fine level, which is a ParDIA; the sharded
        AMG-preconditioned PCG (tol 1e-8) takes the serial count;
    (b) hybrid symmetric GS (relax 6, ext+i) at nx_gs^3, max_levels
        3, repl_threshold 400, at least two sharded levels: the sharded
        PCG count (the JAX package's at the same shard count is pinned
        by the callers);
    (c) the general-CSR setup chain 0 -> 1 -> 2 at nx_setup^3 on the
        mesh: the CF split and P bitwise the serial host pipeline's on
        the same operators at both transitions.

    Shards live on `devices` (default: CUDA device s of the card(s), or
    the CPU when device="cpu"); the serial hierarchies on the first
    one.  Raises if a leg fails; returns the counts, and in
    out["solvers"][leg] the (serial BoomerAMG, ParAMG, b's blocks) of
    legs a and b."""
    import scipy.sparse as sp

    from .models import laplacian_7pt_row_block
    from .parallel import ParCSR, make_mesh
    from .parallel.dist_csr_setup import dist_csr_hierarchy
    from .parallel.par_amg import ParAMG
    from .parallel.par_dia import ParDIA
    from .parallel.partition import block_partition
    from .solvers.amg.coarsen import pmis_coarsen
    from .solvers.amg.interp import classical_interp
    from .solvers.amg.strength import strength_matrix

    if devices is None and torch.device(device).type == "cpu":
        devices = ["cpu"] * n_devices
    mesh = make_mesh(n_devices, devices)
    dev0 = mesh.devices[0]
    S = n_devices
    out = {"devices": [str(d) for d in mesh.devices], "solvers": {}}

    # (a) the l1-Jacobi leg
    n = nx**3
    A = laplacian_7pt(nx, nx, nx)
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False), device=dev0)
    per = block_partition(n, S).rows_per_shard
    blocks = [laplacian_7pt_row_block(nx, nx, nx, min(s * per, n),
                                      min(s * per + per, n)) for s in range(S)]
    A_blocks = ParCSR.from_row_blocks(blocks, (n, n), mesh)
    pamg = ParAMG(amg, mesh, repl_threshold=1500)
    P = pamg.fine
    if not isinstance(P, ParDIA):
        raise AssertionError(f"the fine level is {type(P).__name__}, not "
                             "ParDIA")
    xt = np.random.default_rng(0).standard_normal(n)
    ya = A_blocks.unpad(A_blocks.matvec(A_blocks.pad_vec(xt)))
    yb = P.unpad(P.matvec(P.pad_vec(xt)))
    err = float(np.abs(ya - yb).max() / np.abs(yb).max())
    if err > 1e-12:
        raise AssertionError(f"row-block and sliced fine operators differ "
                             f"by {err:.3e}")
    plans = [lvl.A.plan.offsets or "allgather"
             for lvl in pamg.par_levels[1:] if hasattr(lvl.A, "plan")]
    b_host = A.to_scipy() @ np.ones(n)
    opts = PCGOptions(tol=1e-8, max_iter=40)
    res = pcg(P.matvec_fn, P.pad_vec(b_host), M=pamg.precond, opts=opts)
    x = P.unpad(res.x)
    if not np.isfinite(x).all():
        raise AssertionError("the sharded solve is not finite")
    E = amg.levels[0].A
    ser = pcg(lambda v: spmv(E, v), torch.from_numpy(b_host).to(dev0),
              M=amg.precond, opts=opts)
    if ser.num_iterations != res.num_iterations:
        raise AssertionError(f"iteration parity broken: serial "
                             f"{ser.num_iterations} vs sharded "
                             f"{res.num_iterations}")
    out["a"] = {"rows": n, "iterations": res.num_iterations,
                "serial_iterations": ser.num_iterations,
                "sharded_levels": len(pamg.par_levels),
                "replicated_levels": len(pamg.tail_levels),
                "fine": type(P).__name__, "level_plans": plans,
                "row_block_err": err,
                "rel_residual": float(res.rel_residual_norm)}
    log(f"dryrun (a): {S} shards, {n} rows, {len(pamg.par_levels)} sharded "
        f"(fine {type(P).__name__}) + {len(pamg.tail_levels)} replicated "
        f"levels, {res.num_iterations} PCG iterations (serial "
        f"{ser.num_iterations}), coarse-level halo offsets {plans}")
    out["solvers"]["a"] = (amg, pamg, P.pad_vec(b_host))
    del A_blocks

    # (b) hybrid symmetric GS, sharded
    ng = nx_gs**3
    A_gs = laplacian_7pt(nx_gs, nx_gs, nx_gs)
    amg_gs = BoomerAMG(A_gs, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=6, relax_up=6, embed_level1=False, max_levels=3),
        device=dev0)
    pamg_gs = ParAMG(amg_gs, mesh, repl_threshold=400)
    if pamg_gs.fine is None or len(pamg_gs.par_levels) < 2:
        raise AssertionError(f"hybrid-GS leg: {len(pamg_gs.par_levels)} "
                             "sharded levels, expected >= 2")
    Fg = pamg_gs.fine
    b_gs = Fg.pad_vec(A_gs.to_scipy() @ np.ones(ng))
    res_gs = pcg(Fg.matvec_fn, b_gs, M=pamg_gs.precond, opts=opts)
    if not np.isfinite(Fg.unpad(res_gs.x)).all():
        raise AssertionError("the hybrid-GS solve is not finite")
    its = res_gs.num_iterations
    out["b"] = {"rows": ng, "iterations": its,
                "sharded_levels": len(pamg_gs.par_levels),
                "res_norms": [float(v) for v in res_gs.res_norms[: its + 1]]}
    log(f"dryrun (b): hybrid SSOR (relax 6) sharded solve at {nx_gs}^3, "
        f"{its} PCG iterations, {len(pamg_gs.par_levels)} sharded levels")
    out["solvers"]["b"] = (amg_gs, pamg_gs, b_gs)

    # (c) the general-CSR setup chain, two transitions deep
    Ad = laplacian_7pt(nx_setup, nx_setup, nx_setup).to_scipy().tocsr()
    levels, Ps, cfs = dist_csr_hierarchy(ParCSR(Ad, mesh), max_levels=3)
    if len(levels) != 3:
        raise AssertionError("distributed setup: expected 2 transitions")
    for l in range(2):
        Al = sp.vstack(levels[l].host_blocks).tocsr()[: levels[l].n]
        Sl = strength_matrix(Al)
        cf_h = pmis_coarsen(Sl)
        if not (cfs[l] == cf_h).all():
            raise AssertionError(f"distributed setup: level {l} CF split "
                                 "diverged")
        dP = (sp.vstack(Ps[l].host_blocks).tocsr()[: levels[l].n]
              - classical_interp(Al, Sl, cf_h)).tocoo()
        if dP.nnz and np.abs(dP.data).max() != 0.0:
            raise AssertionError(f"distributed setup: level {l} P diverged")
    out["c"] = {"rows": [lv.n for lv in levels]}
    log(f"dryrun (c): general-CSR chain 0->1->2 on {S} shards "
        f"({' -> '.join(str(lv.n) for lv in levels)} rows), CF and P "
        f"bitwise the serial pipeline's at both transitions")
    return out
