"""The PyTorch port (hypre_tpu_torch) and chip_smoke.py load neither
jax nor the JAX package hypre_tpu."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "hypre_tpu_torch",
    "hypre_tpu_torch.convert",
    "hypre_tpu_torch.entry",
    "hypre_tpu_torch.native",
    "hypre_tpu_torch.profile_slice",
    "hypre_tpu_torch.lane_sweep",
    "hypre_tpu_torch.models.laplacian",
    "hypre_tpu_torch.ops.cell_dense_kernel",
    "hypre_tpu_torch.ops.csr",
    "hypre_tpu_torch.ops.device_rap",
    "hypre_tpu_torch.ops.dia",
    "hypre_tpu_torch.ops.dia_kernel",
    "hypre_tpu_torch.ops.ell_kernel",
    "hypre_tpu_torch.ops.forms",
    "hypre_tpu_torch.ops.gather_kernel",
    "hypre_tpu_torch.ops.gs_kernel",
    "hypre_tpu_torch.ops.spmv",
    "hypre_tpu_torch.ops.tail_kernel",
    "hypre_tpu_torch.solvers.amg.boomeramg",
    "hypre_tpu_torch.solvers.amg.coarsen",
    "hypre_tpu_torch.solvers.amg.interp",
    "hypre_tpu_torch.solvers.amg.rap",
    "hypre_tpu_torch.solvers.amg.relax",
    "hypre_tpu_torch.solvers.amg.strength",
    "hypre_tpu_torch.solvers.krylov.common",
    "hypre_tpu_torch.solvers.krylov.pcg",
    "hypre_tpu_torch.utils.errors",
    "hypre_tpu_torch.utils.lcg",
    "hypre_tpu_torch.utils.timing",
]

_PROBE = """
import importlib, sys
for m in sys.argv[1:]:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "hypre_tpu"))
print(bad)
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("modules", [SLICE_MODULES, ["chip_smoke"]],
                         ids=["hypre_tpu_torch", "chip_smoke"])
def test_no_jax_loaded(modules):
    r = subprocess.run([sys.executable, "-c", _PROBE, *modules], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
