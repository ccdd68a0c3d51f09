"""Time the ELL kernel at every slot-lane count on the 96^3 operators,
or K1 at every offset-lane count on the 96^3 lattice operators.

    python -m hypre_tpu_torch.lane_sweep [--k1]

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
picks: what that rule's constants were chosen from.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse

import torch

from .models import laplacian_7pt
from .ops import (DIAMatrix, DIAWithTail, ELLMatrix, ParityInterpOp,
                  ParityRestrictOp)
from .ops.dia_kernel import MAX_BY_VALUE, dia_spmv_cuda, offset_lanes
from .ops.ell_kernel import ell_spmv_cuda, slot_lanes
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .utils.timing import time_cuda_ms

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k1", action="store_true",
                    help="sweep K1's offset lanes on the lattice operators "
                         "instead of the ELL kernel's slot lanes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lane_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.k1:
        k1_sweep(dev, flush, gen)
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
