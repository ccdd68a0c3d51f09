"""`ij` driver (port of hypre_tpu/drivers/ij.py) — mirrors the reference
test/ij.c CLI subset.

Run: python -m hypre_tpu_torch.drivers.ij [flags] [--device cpu|cuda]
(the card by default).  Supported flags (same spellings):
  -n nx ny nz        problem size                (default 10 10 10)
  -c cx cy cz        diffusion coefficients
  -9pt | -27pt       stencil choice (2D 9pt / 3D 27pt Laplacian)
  -difconv -a ax ay az [-atype k]   convection-diffusion
  -solver ID         0 AMG, 1 AMG-PCG, 2 DS-PCG, 3 AMG-GMRES, 4 DS-GMRES,
                     5 AMG-CGNR, 6 DS-CGNR, 9 AMG-BiCGSTAB, 10 DS-BiCGSTAB,
                     20 AMG-hybrid, 50 DS-LGMRES, 51 AMG-LGMRES,
                     60 DS-FlexGMRES, 61 AMG-FlexGMRES, 16 AMG-COGMRES,
                     80 ILU, 81 ILU-GMRES
  -pmis|-hmis|-ruge|-cljp|-falgout|-cgc|-cr   coarsening
  -interptype K      0 classical | 3 direct | 4 multipass | 6 ext+i |
                     8 standard | 9 standard-sep | 12 FF | 13 FF1 | 14 ext
  -sysL n  -sysL_opt k  -nf n   systems Laplacian / num functions
  -nodal k  -gsmg k  -Pmx K  -rlx K  -th T  -mxrs R
  -agg_nl N  -agg_interp K (4 multipass, 1 product)
  -tol T  -max_iter N  -k K (k_dim)  -w W  -ow W  -wl W L  -owl W L
  -additive L  -mult_add L  -simple L  -add_Pmx K  -add_tr T  -add_rlx K
  -CF k  -restritype k  -ns N  -ns_down N  -ns_up N  -ns_coarse N
  -min_cs N  -seq_th N  -Sabs
  -smtype 6|8|9  -smlv N  -eu_level K   complex smoothers on N levels
  -ilu_type 0|1  -ilu_lfil K  -ilu_droptol T   (solvers 80 / 81)
  -xisone | -rhsrand | -rhszero      rhs setup
  -print             write IJ.out.A.00000 / IJ.out.b.00000
Output matches the reference's lines so .saved-style checks apply:
  "Iterations = N" / "Final Relative Residual Norm = %e".

The problem and the solve run in float64 on `device` (the options'
default dtype; the JAX driver switches jax_enable_x64 on for the same
end).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

INTERP = {0: "classical", 3: "direct", 4: "multipass", 6: "ext+i", 8: "standard", 9: "standard-sep", 12: "ff", 13: "ff1", 14: "ext"}


def run(argv=None, *, device="cuda"):
    """Run one ij command line on `device`; prints the reference's lines
    and returns the solver's result, which also carries what the run
    built: `op` (the frozen fine operator), `amg` (the BoomerAMG
    hierarchy, or None), and with solver 20 `hybrid`, with 80 / 81
    `ilu`."""
    from ..models import (
        difconv_7pt, laplacian_7pt, laplacian_9pt, laplacian_27pt,
        sys_laplacian_7pt,
    )
    from ..ops.csr import CSRMatrix, to_device
    from ..ops.dia import freeze_auto, spmv
    from ..solvers.amg import BoomerAMG, BoomerAMGOptions
    from ..solvers.amg.hybrid import AMGHybrid, AMGHybridOptions
    from ..solvers.krylov import (
        BiCGSTABOptions, CGNROptions, COGMRESOptions, FlexGMRESOptions,
        GMRESOptions, LGMRESOptions, PCGOptions,
        bicgstab, cgnr, cogmres, flexgmres, gmres, lgmres, pcg,
    )

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
    use9 = flag("-9pt")
    use27 = flag("-27pt")
    difconv = flag("-difconv")
    ax, ay, az = flag("-a", 3, [1.0, 1.0, 1.0])
    atype = flag("-atype", 1, 0, int)
    solver_id = flag("-solver", 1, 0, int)
    coarsen = "pmis" if flag("-pmis") else ("hmis" if flag("-hmis") else ("rs" if flag("-ruge") else "pmis"))
    if flag("-cljp"):
        coarsen = "cljp"
    if flag("-falgout"):
        coarsen = "falgout"
    if flag("-cgc"):
        coarsen = "cgc"
    if flag("-cr"):
        coarsen = "cr"
    if flag("-pmis1"):
        coarsen = "pmis"
    interp = INTERP.get(flag("-interptype", 1, 6, int), "ext+i")
    pmx = flag("-Pmx", 1, 4, int)
    rlx = flag("-rlx", 1, -1, int)
    theta = flag("-th", 1, 0.25)
    mxrs = flag("-mxrs", 1, 1.0)
    agg_nl = flag("-agg_nl", 1, 0, int)
    sysl = flag("-sysL", 1, 0, int)
    sysl_opt = flag("-sysL_opt", 1, 0, int)
    nodal = flag("-nodal", 1, 0, int)
    gsmg = flag("-gsmg", 1, 0, int)
    num_fun = flag("-nf", 1, 0, int) or sysl
    agg_interp = flag("-agg_interp", 1, 4, int)
    tol = flag("-tol", 1, 1e-8)
    max_iter = flag("-max_iter", 1, 100, int)
    kdim = flag("-k", 1, 5, int)
    w = flag("-w", 1, 1.0)
    om = flag("-ow", 1, 1.0)  # outer SOR weight (ij.c:1261 -ow, SetOuterWt)
    # -wl <wt> <level> / -owl <wt> <level> (SetLevelRelaxWt/
    # SetLevelOuterWt): one level's weight; tuple clamping keeps the
    # scalar default beyond it
    wl = flag("-wl", 2, None)
    owl = flag("-owl", 2, None)
    lvl_w = None
    if wl is not None:
        lvl_w = (w,) * int(wl[1]) + (float(wl[0]), w)
    lvl_ow = None
    if owl is not None:
        lvl_ow = (om,) * int(owl[1]) + (float(owl[0]), om)
    # additive variants (ij.c:1580-1610)
    additive = flag("-additive", 1, -1, int)
    mult_add = flag("-mult_add", 1, -1, int)
    simple = flag("-simple", 1, -1, int)
    add_pmx = flag("-add_Pmx", 1, 0, int)
    add_tr = flag("-add_tr", 1, 0.0)
    add_rlx = flag("-add_rlx", 1, 18, int)
    cf_order = flag("-CF", 1, 0, int)
    restri = flag("-restritype", 1, 0, int)  # ij.c AIR restriction
    ilu_type = flag("-ilu_type", 1, 0, int)  # 0 ILU(k) | 1 ILUT
    ilu_lfil = flag("-ilu_lfil", 1, 0, int)
    ilu_drop = flag("-ilu_droptol", 1, 0.01)
    ns = flag("-ns", 1, 1, int)
    ns_down = flag("-ns_down", 1, 0, int)
    ns_up = flag("-ns_up", 1, 0, int)
    ns_coarse = flag("-ns_coarse", 1, 0, int)
    min_cs = flag("-min_cs", 1, 0, int)
    seq_th = flag("-seq_th", 1, 0, int)
    sabs = flag("-Sabs")
    xisone = flag("-xisone")
    rhsrand = flag("-rhsrand")
    rhszero = flag("-rhszero")
    do_print = flag("-print")

    if sysl and sysl > 1:
        A = sys_laplacian_7pt(nx, ny, nz, sysl, sys_opt=sysl_opt)
    elif use9:
        A = laplacian_9pt(nx, ny)
    elif use27:
        A = laplacian_27pt(nx, ny, nz)
    elif difconv:
        A = difconv_7pt(nx, ny, nz, cx, cy, cz, ax, ay, az, atype)
    else:
        A = laplacian_7pt(nx, ny, nz, cx, cy, cz)
    n = A.num_rows

    rng = np.random.default_rng(2747)
    if xisone:
        b_host = A.to_scipy() @ np.ones(n)
    elif rhsrand:
        b_host = rng.standard_normal(n)
    elif rhszero:
        b_host = np.zeros(n)
    else:
        b_host = np.ones(n)
    b = to_device(b_host, torch.float64, dev)

    relax = {"down": 13, "up": 14}
    if rlx >= 0:
        relax = {"down": rlx, "up": {3: 4, 13: 14}.get(rlx, rlx)}
    smtype = flag("-smtype", 1, 0, int)
    smlv = flag("-smlv", 1, 0, int)
    eu_level = flag("-eu_level", 1, 1, int)

    amg_opts = BoomerAMGOptions(
        coarsen_type=coarsen,
        interp_type=interp,
        P_max_elmts=pmx,
        smooth_type=smtype,
        smooth_num_levels=smlv,
        euclid_fill=eu_level,
        strong_threshold=theta,
        max_row_sum=mxrs,
        relax_down=relax["down"],
        relax_up=relax["up"],
        relax_weight=w,
        omega=om,
        level_relax_weights=lvl_w,
        level_omegas=lvl_ow,
        additive=additive,
        mult_additive=mult_add,
        simple=simple,
        add_P_max_elmts=add_pmx,
        add_trunc_factor=add_tr,
        add_rlx=add_rlx,
        agg_num_levels=agg_nl,
        agg_interp_type=agg_interp,
        num_functions=max(num_fun, 1),
        nodal=nodal,
        gsmg=gsmg,
        relax_order=cf_order,
        restrict_type=restri,
        num_sweeps=ns,
        num_sweeps_down=ns_down or None,
        num_sweeps_up=ns_up or None,
        num_sweeps_coarse=ns_coarse or None,
        min_coarse_size=min_cs,
        seq_threshold=seq_th,
        strength_abs=bool(sabs),
        lattice_shape=None if (sysl and sysl > 1) else ((nx, ny) if use9 else (nx, ny, nz)),
    )

    needs_amg = solver_id in (0, 1, 3, 5, 9, 51, 61, 16)
    amg = BoomerAMG(A, amg_opts, device=dev) if needs_amg else None
    E = freeze_auto(A, torch.float64, dev)
    op = lambda x: spmv(E, x)  # noqa: E731
    dinv = to_device(1.0 / A.diagonal(), torch.float64, dev)
    ds = lambda r: dinv * r  # noqa: E731
    M = amg.precond if amg else ds

    if do_print:
        from ..utils.io import write_ij_matrix, write_ij_vector

        write_ij_matrix(A, "IJ.out.A")
        write_ij_vector(b_host, "IJ.out.b")

    if amg:
        print(f" Coarsening Type = {coarsen.upper()}")
        print(f" Interpolation = {interp}")
        print(f"     Complexity:    grid = {amg.grid_complexity():.6f}")
        print(f"                operator = {amg.operator_complexity():.6f}")

    if solver_id == 0:
        res = amg.solve(b, tol=tol, max_iter=max_iter)
        iters = int(res.num_iterations)
        norms = res.res_norms.cpu().numpy()
        if iters > 0 and norms[0] > 0:
            cf = (norms[iters] / norms[0]) ** (1.0 / iters)
            print(f" Average Convergence Factor = {cf:.6f}")
        print(f"BoomerAMG Iterations = {iters}")
    elif solver_id in (1, 2):
        res = pcg(op, b, M=M if solver_id == 1 else ds, opts=PCGOptions(tol=tol, max_iter=max_iter, two_norm=True))
        print(f"Iterations = {int(res.num_iterations)}")
    elif solver_id in (3, 4):
        res = gmres(op, b, M=M if solver_id == 3 else ds, opts=GMRESOptions(tol=tol, max_iter=max_iter, k_dim=kdim))
        print(f"GMRES Iterations = {int(res.num_iterations)}")
    elif solver_id in (5, 6):
        ET = freeze_auto(CSRMatrix.from_scipy(A.to_scipy().T.tocsr()),
                         torch.float64, dev)
        res = cgnr(op, lambda x: spmv(ET, x), b, M=M if solver_id == 5 else ds, opts=CGNROptions(tol=tol, max_iter=max_iter))
        print(f"Iterations = {int(res.num_iterations)}")
    elif solver_id in (9, 10):
        res = bicgstab(op, b, M=M if solver_id == 9 else ds, opts=BiCGSTABOptions(tol=tol, max_iter=max_iter))
        print(f"BiCGSTAB Iterations = {int(res.num_iterations)}")
    elif solver_id == 16:
        res = cogmres(op, b, M=M, opts=COGMRESOptions(tol=tol, max_iter=max_iter, k_dim=kdim))
        print(f"COGMRES Iterations = {int(res.num_iterations)}")
    elif solver_id == 20:
        h = AMGHybrid(A, AMGHybridOptions(tol=tol, amg=amg_opts), device=dev)
        res = h.solve(b)
        res.hybrid = h
        print(f"Iterations = {int(res.num_iterations)}")
    elif solver_id in (50, 51):
        res = lgmres(op, b, M=M if solver_id == 51 else ds, opts=LGMRESOptions(tol=tol, max_iter=max_iter, k_dim=max(kdim, 10)))
        print(f"LGMRES Iterations = {int(res.num_iterations)}")
    elif solver_id in (60, 61):
        res = flexgmres(op, b, M=M if solver_id == 61 else ds, opts=FlexGMRESOptions(tol=tol, max_iter=max_iter, k_dim=kdim))
        print(f"FlexGMRES Iterations = {int(res.num_iterations)}")
    elif solver_id in (80, 81):
        # ij.c: 80 = hypre_ILU standalone (stationary ILU iteration),
        # 81 = ILU-GMRES; native ILU(k)/ILUT factorizations
        from ..solvers.amg.ilu import ILU, ILUOptions
        from ..solvers.krylov.common import SolverResult

        ilu = ILU(A, ILUOptions(type=ilu_type, fill_level=ilu_lfil,
                                droptol=ilu_drop), device=dev)
        if solver_id == 80:
            # the stationary iteration, one host read of the residual
            # norm a step
            x = torch.zeros_like(b)
            bn = float(torch.linalg.vector_norm(b)) or 1.0
            rel = 1.0
            it = 0
            for it in range(1, max_iter + 1):
                x = x + ilu.solve(b - op(x))
                rel = float(torch.linalg.vector_norm(b - op(x))) / bn
                if rel < tol:
                    break
            res = SolverResult(x=x, num_iterations=it,
                               rel_residual_norm=torch.tensor(rel),
                               converged=rel < tol, res_norms=None)
            print(f"ILU Iterations = {it}")
        else:
            res = gmres(op, b, M=ilu.precond,
                        opts=GMRESOptions(tol=tol, max_iter=max_iter,
                                          k_dim=kdim))
            print(f"GMRES Iterations = {int(res.num_iterations)}")
        res.ilu = ilu
    else:
        raise SystemExit(f"solver {solver_id} not implemented")
    res.amg, res.op = amg, E

    print(f"Final Relative Residual Norm = {float(res.rel_residual_norm):e}")
    if not bool(res.converged):
        # record in the global flag (hypre_error.h HYPRE_ERROR_CONV) —
        # the reference drivers poll HYPRE_GetError after solves
        from ..utils.errors import CONV, describe_error, set_error

        set_error(CONV)
        print(f"hypre error: {describe_error(CONV)}")
    return res


def main(argv=None) -> None:
    """The command line: the ij flags, and `--device cpu|cuda`."""
    a = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in a:
        i = a.index("--device")
        device = a[i + 1]
        del a[i : i + 2]
    run(a, device=device)


if __name__ == "__main__":
    main()
