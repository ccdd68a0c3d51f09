"""Time the ELL kernel at every slot-lane count on the 96^3 operators,
K1 at every offset-lane count on the 96^3 lattice operators, the GS
sweep at every lane count in both its forms on the 96^3 levels, or the
gathers' tiled form under several launch plans at the probes' shapes.

    python -m hypre_tpu_torch.lane_sweep [--k1 | --gs | --gathers]

Sets up the slice's hierarchy at 96^3 in float64, and in float32 with
bfloat16 matrices and nongalerkin_tol 0.02, and times the ELL kernel's
plain and resid forms on each ELL operator at S = 1, 2, 4, 8 and 16
slot lanes a row (L2 flushed, utils/timing.py::time_cuda_ms), beside
the S that ops/ell_kernel.py::slot_lanes picks.  The table is what
slot_lanes's two constants were chosen from; rerun it to retune them
when the card or the hierarchy's operators change.

With --k1 it sets up the lattice hierarchy instead (the JAX package's
option defaults: embedded level 1, relocated levels with parity
transfers) and times K1's plain form on every DIA part with more than
8 offsets at S = 1 ... 32 offset lanes a row (a parity operator's
matrices summed), beside the S that ops/dia_kernel.py::offset_lanes
picks: what that rule's constants were chosen from.

With --gs it sets up the relax 13 / 14 hierarchy in float64 (the plain
forms) and times one forward and one backward sweep of every level
(ops/gs_kernel.py::gs_sweep_cuda, plain form) at S = 1 ... 32 lanes a
row in the wavefront form's one-block and cooperative-grid variants and
in the sync-free form, then the sync-free form by grid cap, beside the
form and S the wrapper picks (ONE_BLOCK_MAX_ROWS, row_lanes,
free_lanes, DEFAULT_FORM): what those were chosen from.

With --gathers it times the tiled take_along_axis at the TPU gather
probes' shapes (K2 (a), (b), K3; scripts/exp_mosaic_gather.py) under
launch plans that override `take_plan`'s choices (instance, span of an
idx row a segment, blocks a group, threads), and the tiled flat_take
(K2 (c), the lattice path's 1,529 f64 / 1,731 f32 gathers, 2M and 8M)
by block size and grid, each beside the plan's own choice and the
elementwise form, timed before and after the row, with K3 also after an
L2 flush that reads (`time_clean_l2_ms`): what the plans' rules were
chosen from.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from .models import laplacian_7pt
from .ops import (DIAMatrix, DIAWithTail, ELLMatrix, ParityInterpOp,
                  ParityRestrictOp)
from .ops.dia_kernel import MAX_BY_VALUE, dia_spmv_cuda, offset_lanes
from .ops.ell_kernel import ell_spmv_cuda, slot_lanes
from .ops.gather_kernel import (flat_plan, flat_take_cuda,
                                take_along_axis_cuda, take_plan)
from .ops.gs_kernel import (DEFAULT_FORM, ONE_BLOCK_MAX_ROWS, clear_fault,
                             free_lanes, gs_sweep_cuda, read_fault, row_lanes)
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .utils.timing import LEAD_CYCLES, REPS, time_cuda_ms

NX = 96
CONFIGS = {"f64": dict(dtype="float64"),
           "bf16/f32": dict(dtype="float32", mat_dtype="bfloat16",
                            nongalerkin_tol=0.02)}


def _dia_parts(A) -> list:
    """The DIA matrices one application of A launches K1 on."""
    if isinstance(A, DIAMatrix):
        return [A]
    if isinstance(A, DIAWithTail):
        return [A.dia]
    if isinstance(A, (ParityInterpOp, ParityRestrictOp)):
        return list(A.mats)
    return []


def k1_sweep(dev, flush, gen) -> None:
    print(f"{torch.cuda.get_device_name(0)}; K1 plain form, us, median of "
          "50, L2 flushed, at each S offset lanes (a parity operator's "
          "matrices summed)")
    for label, kw in CONFIGS.items():
        opts = BoomerAMGOptions(
            coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
            relax_down=18, relax_up=18, lattice_shape=(NX, NX, NX),
            device_rap=False, **kw)
        amg = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device=dev)
        vdt = amg.levels[0].dinv.dtype
        for l, lvl in enumerate(amg.levels[:-1]):
            for name, A in (("A", lvl.A), ("P", lvl.P), ("R", lvl.R)):
                mats = [m for m in _dia_parts(A)
                        if len(m.offsets) > MAX_BY_VALUE]
                if not mats:
                    continue
                n = mats[0].num_rows
                x = torch.randn(n, device=dev, dtype=vdt, generator=gen)
                cells = []
                for s in (1, 2, 4, 8, 16, 32):
                    us = sum(time_cuda_ms(lambda m=m: dia_spmv_cuda(
                        m.data, m.offsets, x, lanes=s), flush) for m in mats)
                    cells.append(f"S={s} {us * 1e3:.1f}")
                noffs = [len(m.offsets) for m in mats]
                picks = sorted({offset_lanes(n, k) for k in noffs})
                print(f"{label} L{l} {name} {type(A).__name__} {n} rows, "
                      f"offsets {noffs}: picks S={picks}; " + ", ".join(cells),
                      flush=True)
        del amg
        torch.cuda.empty_cache()


def gs_sweep(dev, flush, gen) -> None:
    print(f"{torch.cuda.get_device_name(0)}; GS sweep (plain form), us, "
          "median of 20, L2 flushed; the wavefront form one block / grid "
          "and the sync-free form at each S lanes a row; then the "
          "sync-free form at the wrapper's S by grid cap (blocks, 0: all "
          "that can be resident)")
    opts = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=13, relax_up=14, embed_level1=False,
        relocate_level2=False, collapse_coarse_n=0)
    amg = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device=dev)
    clear_fault(dev)
    for l, lvl in enumerate(amg.levels[:-1]):
        for d, S in (("fwd", lvl.gs_fwd), ("bwd", lvl.gs_bwd)):
            u = torch.randn(S.n, device=dev, dtype=torch.float64, generator=gen)
            f = torch.randn(S.n, device=dev, dtype=torch.float64, generator=gen)
            cells = []
            for s in (1, 2, 4, 8, 16, 32):
                if s > 2 * free_lanes(S.max_row):
                    break
                t = [time_cuda_ms(lambda c=c: gs_sweep_cuda(
                    S, u, f, form="wavefront", coop=c, lanes=s), flush, 20)
                    for c in (False, True)]
                t.append(time_cuda_ms(lambda: gs_sweep_cuda(
                    S, u, f, form="syncfree", lanes=s), flush, 20))
                cells.append(f"S={s} {t[0] * 1e3:.1f}/{t[1] * 1e3:.1f}/"
                             f"{t[2] * 1e3:.1f}")
            grid = S.max_width > ONE_BLOCK_MAX_ROWS
            picks = (f"wavefront form {'grid' if grid else 'one block'} S="
                     f"{row_lanes(S.max_row, S.max_width, not grid)}, "
                     f"sync-free S={free_lanes(S.max_row)}, default "
                     f"{DEFAULT_FORM}")
            print(f"L{l} {d} {S.n} rows, {S.num_wavefronts} wavefronts, widest "
                  f"{S.max_width}, longest row {S.max_row}: picks {picks}; "
                  + ", ".join(cells), flush=True)
            grids = []
            for blocks in (0, 264, 132, 66, 16):
                t = time_cuda_ms(lambda: gs_sweep_cuda(
                    S, u, f, form="syncfree", blocks=blocks), flush, 20)
                grids.append(f"{blocks} {t * 1e3:.1f}")
            print(f"L{l} {d} sync-free by blocks: " + ", ".join(grids),
                  flush=True)
    torch.cuda.synchronize()
    if read_fault(dev):
        raise SystemExit(f"a sync-free GS wait gave up: fault word "
                         f"{read_fault(dev)}")


def time_clean_l2_ms(fn, flush: torch.Tensor, reps: int = REPS) -> float:
    """time_cuda_ms's method with L2 flushed by reading `flush`: clean
    lines, so fn's misses evict nothing that must be written back.  A
    diagnostic of K3 (the write-back's share of its time); every number
    the port reports uses time_cuda_ms."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(LEAD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def gather_sweep(dev, flush, gen) -> None:
    print(f"{torch.cuda.get_device_name(0)}; gathers, us, median of 50, L2 "
          "flushed (written); each row: the plan's knobs, its grid and "
          "threads, then its time; 'plan' is take_plan's / flat_plan's own "
          "choice, 'elementwise' the earlier form, timed first and last")

    def ints(shape, hi):
        return torch.randint(0, hi, shape, device=dev, generator=gen,
                             dtype=torch.int32)

    takes = {
        "K2 (a)": ((64, 512), (64, 512), 1, [
            {}, {"batch": 8}, {"span": 256, "spread": 2},
            {"span": 128, "spread": 4}, {"span": 64, "spread": 8},
            {"instance": "l2"}, {"instance": "l2", "span": 128,
                                 "spread": 4}]),
        "K2 (b)": ((64, 512), (64, 512), 0, [
            {}, {"batch": 8}, {"spread": 1}, {"spread": 2}, {"spread": 8},
            {"spread": 16},
            {"instance": "l2"}, {"instance": "l2", "spread": 1},
            {"instance": "l2", "spread": 16}]),
        "K3": ((512, 512), (4096, 512), 1, [
            {}, {"spread": 2}, {"spread": 4}, {"spread": 8},
            {"spread": 8, "batch": 8}, {"spread": 2, "threads": 64},
            {"instance": "l2"}, {"instance": "l2", "spread": 4}]),
    }
    for label, (xs, ish, axis, knobs) in takes.items():
        x = torch.randn(xs, device=dev, generator=gen)
        i = ints(ish, xs[1] if axis == 1 else xs[0])
        old = time_cuda_ms(lambda: take_along_axis_cuda(
            x, i, axis, form="elementwise"), flush)
        cells = []
        for kw in knobs:
            plan = take_plan(xs, ish, axis, **kw)
            t = time_cuda_ms(lambda: take_along_axis_cuda(x, i, axis,
                                                          plan=plan), flush)
            cells.append(f"{kw or 'plan'} {plan.instance} {plan.grid}x"
                         f"{plan.threads}: {t * 1e3:.2f}")
        old2 = time_cuda_ms(lambda: take_along_axis_cuda(
            x, i, axis, form="elementwise"), flush)
        print(f"{label} x {xs} idx {ish} axis {axis}: elementwise "
              f"{old * 1e3:.2f} / {old2 * 1e3:.2f}; " + "; ".join(cells),
              flush=True)
        if label == "K3":
            t = [time_clean_l2_ms(lambda f=f: take_along_axis_cuda(
                x, i, axis, form=f), flush)
                for f in ("tiled", "elementwise")]
            print(f"K3 after a read flush (clean L2): tiled {t[0] * 1e3:.2f}, "
                  f"elementwise {t[1] * 1e3:.2f}", flush=True)
    for label, n, table, dt in (("K2 (c)", 32_768, 131_072, torch.float32),
                                ("path f64", 1_529, 3_456, torch.float64),
                                ("path f32", 1_731, 3_456, torch.float32),
                                ("2M", 2_097_152, 131_072, torch.float32),
                                ("8M", 8_388_608, 131_072, torch.float32)):
        tbl = torch.randn(table, device=dev, generator=gen, dtype=dt)
        i = ints((n,), table)
        old = time_cuda_ms(lambda: flat_take_cuda(tbl, i, form="elementwise"),
                           flush)
        cells = []
        # the plan's (a thread an element), then with fewer threads a
        # block, and on the grid the card holds at once
        for kw in ({}, {"threads": 128}, {"threads": 64},
                   {"blocks": min(-(-n // 256), 132 * 8)}):
            plan = flat_plan(n, **kw)
            t = time_cuda_ms(lambda: flat_take_cuda(tbl, i, plan=plan), flush)
            cells.append(f"{kw or 'plan'} {plan.blocks}x{plan.threads}: "
                         f"{t * 1e3:.2f}")
        old2 = time_cuda_ms(lambda: flat_take_cuda(tbl, i, form="elementwise"),
                            flush)
        print(f"flat_take {label} {n} from {table} {dt}: elementwise "
              f"{old * 1e3:.2f} / {old2 * 1e3:.2f}; " + "; ".join(cells),
              flush=True)
    empty = time_cuda_ms(lambda: torch.cuda._sleep(0), flush)
    print(f"empty kernel {empty * 1e3:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1", action="store_true",
                    help="sweep K1's offset lanes on the lattice operators "
                         "instead of the ELL kernel's slot lanes")
    ap.add_argument("--gs", action="store_true",
                    help="sweep the GS kernel's lanes and forms on the "
                         "relax 13 / 14 levels")
    ap.add_argument("--gathers", action="store_true",
                    help="sweep the gathers' launch plans at the probes' "
                         "shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lane_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.k1:
        k1_sweep(dev, flush, gen)
        return
    if args.gs:
        gs_sweep(dev, flush, gen)
        return
    if args.gathers:
        gather_sweep(dev, flush, gen)
        return
    print(f"{torch.cuda.get_device_name(0)}; us, median of 50, L2 flushed; "
          "plain / resid at each S")
    for label, kw in CONFIGS.items():
        opts = BoomerAMGOptions(
            coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
            relax_down=18, relax_up=18, embed_level1=False,
            relocate_level2=False, collapse_coarse_n=0, **kw)
        amg = BoomerAMG(laplacian_7pt(NX, NX, NX), opts, device=dev)
        vdt = amg.levels[0].dinv.dtype
        for l, lvl in enumerate(amg.levels[:-1]):
            for name, A in (("A", lvl.A), ("P", lvl.P), ("R", lvl.R)):
                if not isinstance(A, ELLMatrix):
                    continue
                width, n = A.data.shape
                x = torch.randn(A.num_cols, device=dev, dtype=vdt,
                                generator=gen)
                f = torch.randn(n, device=dev, dtype=vdt, generator=gen)
                cells = []
                for s in (1, 2, 4, 8, 16):
                    if s > 1 and s // 2 >= width:
                        break
                    plain = time_cuda_ms(lambda: ell_spmv_cuda(
                        A.data, A.cols, A.row_len, x, lanes=s), flush)
                    resid = time_cuda_ms(lambda: ell_spmv_cuda(
                        A.data, A.cols, A.row_len, x, "resid", f=f,
                        lanes=s), flush)
                    cells.append(f"S={s} {plain * 1e3:.1f}/{resid * 1e3:.1f}")
                print(f"{label} L{l} {name} {n}x{A.num_cols} width {width}: "
                      f"picks S={slot_lanes(width, n)}; " + ", ".join(cells),
                      flush=True)


if __name__ == "__main__":
    main()
