"""Time the ELL kernel at every slot-lane count on the 96^3 operators.

    python -m hypre_tpu_torch.lane_sweep

Sets up the slice's hierarchy at 96^3 in float64, and in float32 with
bfloat16 matrices and nongalerkin_tol 0.02, and times the ELL kernel's
plain and resid forms on each ELL operator at S = 1, 2, 4, 8 and 16
slot lanes a row (L2 flushed, utils/timing.py::time_cuda_ms), beside
the S that ops/ell_kernel.py::slot_lanes picks.  The table is what
slot_lanes's two constants were chosen from; rerun it to retune them
when the card or the hierarchy's operators change.  Needs a CUDA
device.
"""

from __future__ import annotations

import torch

from .models import laplacian_7pt
from .ops import ELLMatrix
from .ops.ell_kernel import ell_spmv_cuda, slot_lanes
from .solvers.amg import BoomerAMG, BoomerAMGOptions
from .utils.timing import time_cuda_ms

NX = 96
CONFIGS = {"f64": dict(dtype="float64"),
           "bf16/f32": dict(dtype="float32", mat_dtype="bfloat16",
                            nongalerkin_tol=0.02)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lane_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    gen = torch.Generator(device=dev).manual_seed(0)
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
