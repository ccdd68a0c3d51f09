"""`struct` driver (port of hypre_tpu/drivers/struct.py) — mirrors the
reference test/struct.c CLI subset.

Run: python -m hypre_tpu_torch.drivers.struct [flags] [--device cpu|cuda]
(the card by default).  Flags (same spellings):
  -n nx ny nz      grid size (default 10 10 10)
  -c cx cy cz      stencil coefficients
  -d D             dimension (2 or 3)
  -P px py pz  -b bx by bz  -np N   multi-box decomposition (test/struct.c:
                   global extent n * b * P per dim; ranks past prod(P) own
                   nothing)
  -solver ID       0 SMG, 2 SparseMSG, 1 / 3 / 4 PFMG, 8 Jacobi,
                   10 CG+SMG, 11 CG+PFMG, 17 CG+two-step Jacobi,
                   18 CG+diag, 19 CG, 25 hybrid, 30 / 31 / 38 / 39
                   GMRES + SMG / PFMG / diag / none
  -v pre post      relaxation sweeps
  -relax K         0/1 Jacobi (weighted), 2/3 red-black GS
  -skip K          PFMG skip-relax
  -tol T  -max_iter N
Output: "Iterations = N" / "Final Relative Residual Norm = %e".

The problem and the solve run in float64 on `device`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def run(argv=None, *, device="cuda"):
    """Run one struct command line on `device`; prints the reference's
    lines and returns the solver's result, which also carries what the
    run built: `A` (the StructMatrix), `solver` (the PFMG / SMG /
    SparseMSG / StructJacobi / StructHybrid object, or None for the
    unpreconditioned Krylov lines) and, on the -P path, `matvec_err`
    (the multi-box matvec against the canonical one)."""
    from ..solvers.krylov import GMRESOptions, PCGOptions, gmres, pcg
    from ..solvers.struct_ls import (
        PFMG,
        SMG,
        PFMGOptions,
        SMGOptions,
        SparseMSG,
        SparseMSGOptions,
        StructHybrid,
        StructHybridOptions,
        StructJacobi,
        StructJacobiOptions,
    )
    from ..struct import StructGrid, StructMatrix, struct_matvec

    dev = torch.device(device)
    a = list(argv if argv is not None else sys.argv[1:])

    def flag(name, nvals=0, default=None, cast=float):
        if name in a:
            i = a.index(name)
            if nvals == 0:
                a.pop(i)
                return True
            vals = [cast(x) for x in a[i + 1 : i + 1 + nvals]]
            del a[i : i + 1 + nvals]
            return vals if nvals > 1 else vals[0]
        return default

    nx, ny, nz = flag("-n", 3, [10, 10, 10], int) or [10, 10, 10]
    cx, cy, cz = flag("-c", 3, [1.0, 1.0, 1.0])
    dim = flag("-d", 1, 3, int)
    # -P/-b decomposition (test/struct.c semantics): global extent =
    # n * b * P per dim; each of the first prod(P) virtual ranks owns
    # prod(b) boxes; -np ranks beyond prod(P) own NOTHING (emptyproc).
    Pgrid = flag("-P", 3, None, int)
    Bblock = flag("-b", 3, [1, 1, 1], int) or [1, 1, 1]
    vnp = flag("-np", 1, 0, int)
    solver_id = flag("-solver", 1, 0, int)
    n_pre, n_post = flag("-v", 2, [1, 1], int) or [1, 1]
    relax = flag("-relax", 1, 1, int)
    skip = flag("-skip", 1, 0, int)
    tol = flag("-tol", 1, 1e-6)
    max_iter = flag("-max_iter", 1, 200, int)

    if dim == 2:
        nz = 1
        cz = 0.0
    shape = (nx, ny, nz) if dim == 3 else (nx, ny)

    def off(d, s):
        o = [0] * dim
        o[d] = s
        return tuple(o)

    matvec_err = None
    if Pgrid is not None:
        # multi-box path: distribute, build per-box data, run a
        # multi-box matvec consistency check, assemble canonical
        from ..struct.box import distribute_PB
        from ..struct.multibox import (
            MultiBoxGrid,
            MultiBoxVector,
            multibox_matvec,
            to_struct_matrix,
        )

        Pg = list(Pgrid)[:dim]
        Bb = list(Bblock)[:dim]
        nloc = [nx, ny, nz][:dim]
        owners, gbox = distribute_PB(tuple(nloc), tuple(Pg), tuple(Bb),
                                     vnp or int(np.prod(Pg)))
        shape = gbox.shape
        grid_mb = MultiBoxGrid([b for _, b in owners])
        coefs = [cx, cy, cz][:dim]
        diag_val = 2 * sum(coefs)
        ent_mb = {(0,) * dim: {}}
        for d, c in enumerate(coefs):
            ent_mb[off(d, -1)] = {}
            ent_mb[off(d, 1)] = {}
        for i in grid_mb.nonempty:
            bshape = grid_mb.boxes[i].shape
            ent_mb[(0,) * dim][i] = diag_val * np.ones(bshape)
            for d, c in enumerate(coefs):
                ent_mb[off(d, -1)][i] = -c * np.ones(bshape)
                ent_mb[off(d, 1)][i] = -c * np.ones(bshape)
        # canonical assembly through the box maps; non-rectangular
        # unions embed exactly (identity exterior block — see
        # struct/multibox.py to_struct_matrix)
        ent, inside = to_struct_matrix(grid_mb, ent_mb)
        # the multi-box matvec (ghost plans from box intersections)
        # must agree with the canonical stencil apply on the union
        # (outside the union the embedded operator is identity)
        rng = np.random.default_rng(0)
        xt = rng.standard_normal(shape) * inside
        xs = MultiBoxVector.from_global(grid_mb, xt, device=dev)
        y_mb = multibox_matvec(grid_mb, ent_mb, xs).to_global().cpu().numpy()
        A = StructMatrix.from_dict(ent, StructGrid(shape), device=dev)
        y_ref = struct_matvec(A, torch.from_numpy(xt).to(dev)).cpu().numpy() * inside
        np.testing.assert_allclose(y_mb, y_ref, rtol=1e-12, atol=1e-12)
        matvec_err = float(np.abs(y_mb - y_ref).max())
        b = torch.from_numpy(np.ones(shape) * inside).to(dev)
    else:
        ones = np.ones(shape)
        ent = {(0,) * dim: 2 * (cx + cy + (cz if dim == 3 else 0)) * ones}
        for d, c in enumerate([cx, cy, cz][:dim]):
            ent[off(d, -1)] = -c * ones
            ent[off(d, 1)] = -c * ones
        A = StructMatrix.from_dict(ent, StructGrid(shape), device=dev)
        b = torch.ones(shape, dtype=torch.float64, device=dev)

    pf_opts = PFMGOptions(
        tol=tol, max_iter=max_iter, relax_type=relax,
        num_pre_relax=n_pre, num_post_relax=n_post, skip_relax=skip,
    )

    def op(x):
        return struct_matvec(A, x)

    def inv_diag():
        return 1.0 / A.diagonal()

    solver = None
    if solver_id == 0:  # SMG
        solver = SMG(A, SMGOptions(tol=tol, max_iter=max_iter,
                                   num_pre_relax=n_pre, num_post_relax=n_post))
        res = solver.solve(b)
    elif solver_id == 2:  # SparseMSG (struct.c solver 2)
        solver = SparseMSG(A, SparseMSGOptions(tol=tol, max_iter=max_iter,
                                               num_pre=n_pre, num_post=n_post))
        res = solver.solve(b)
    elif solver_id in (1, 3, 4):  # PFMG family
        solver = PFMG(A, pf_opts)
        res = solver.solve(b)
    elif solver_id == 8:
        solver = StructJacobi(A, StructJacobiOptions(tol=tol, max_iter=max_iter))
        res = solver.solve(b)
    elif solver_id == 10:  # CG + SMG
        solver = SMG(A, SMGOptions(num_pre_relax=n_pre, num_post_relax=n_post))
        res = pcg(op, b, M=solver.precond,
                  opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
    elif solver_id == 11:
        solver = PFMG(A, PFMGOptions(relax_type=relax, num_pre_relax=n_pre,
                                     num_post_relax=n_post, skip_relax=skip))
        res = pcg(op, b, M=solver.precond,
                  opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
    elif solver_id == 17:
        # two-step Jacobi preconditioner (struct.c:1643-1652)
        dinv = inv_diag()

        def two_step_jacobi(r):
            x = dinv * r
            return x + dinv * (r - struct_matvec(A, x))

        res = pcg(op, b, M=two_step_jacobi,
                  opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
    elif solver_id == 18:
        # diagonal-scaled PCG (struct.c:1656)
        dinv = inv_diag()
        res = pcg(op, b, M=lambda r: dinv * r,
                  opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
    elif solver_id == 19:
        res = pcg(op, b,
                  opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
    elif solver_id in (30, 31, 38, 39):
        # GMRES family (struct.c solver_id 30-39)
        if solver_id == 30:
            solver = SMG(A, SMGOptions(num_pre_relax=n_pre, num_post_relax=n_post))
            M = solver.precond
        elif solver_id == 31:
            solver = PFMG(A, PFMGOptions(relax_type=relax, num_pre_relax=n_pre,
                                         num_post_relax=n_post, skip_relax=skip))
            M = solver.precond
        elif solver_id == 38:
            dinv = inv_diag()
            M = lambda r: dinv * r
        else:
            M = None
        res = gmres(op, b, M=M, opts=GMRESOptions(tol=tol, max_iter=max_iter))
    elif solver_id == 25:
        solver = StructHybrid(A, StructHybridOptions(tol=tol))
        res = solver.solve(b)
    else:
        raise SystemExit(f"solver {solver_id} not implemented")
    res.A, res.solver, res.matvec_err = A, solver, matvec_err

    print(f"Iterations = {int(res.num_iterations)}")
    print(f"Final Relative Residual Norm = {float(res.rel_residual_norm):e}")
    return res


def main(argv=None) -> None:
    """The command line: the struct flags, and `--device cpu|cuda`."""
    a = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in a:
        i = a.index("--device")
        device = a[i + 1]
        del a[i : i + 2]
    run(a, device=device)


if __name__ == "__main__":
    main()
