"""The PyTorch port (hypre_tpu_torch) and chip_smoke.py load neither
jax nor the JAX package hypre_tpu; every module of the JAX package has
its counterpart in the port but the ones it does not take."""

import os
import pathlib
import subprocess
import sys

import pytest
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE_MODULES = [
    "hypre_tpu_torch",
    "hypre_tpu_torch.convert",
    "hypre_tpu_torch.drivers",
    "hypre_tpu_torch.drivers.ij",
    "hypre_tpu_torch.drivers.sstruct",
    "hypre_tpu_torch.drivers.struct",
    "hypre_tpu_torch.entry",
    "hypre_tpu_torch.native",
    "hypre_tpu_torch.profile_slice",
    "hypre_tpu_torch.lane_sweep",
    "hypre_tpu_torch.models.ij",
    "hypre_tpu_torch.models.laplacian",
    "hypre_tpu_torch.models.maxwell",
    "hypre_tpu_torch.ops.blas1",
    "hypre_tpu_torch.ops.cell_dense_kernel",
    "hypre_tpu_torch.ops.csr",
    "hypre_tpu_torch.ops.device_rap",
    "hypre_tpu_torch.ops.device_setup",
    "hypre_tpu_torch.ops.dia",
    "hypre_tpu_torch.ops.dia_kernel",
    "hypre_tpu_torch.ops.ell_kernel",
    "hypre_tpu_torch.ops.forms",
    "hypre_tpu_torch.ops.gather_kernel",
    "hypre_tpu_torch.ops.gs_kernel",
    "hypre_tpu_torch.ops.matops",
    "hypre_tpu_torch.ops.spmv",
    "hypre_tpu_torch.ops.tail_kernel",
    "hypre_tpu_torch.parallel",
    "hypre_tpu_torch.parallel.dist_csr_setup",
    "hypre_tpu_torch.parallel.dist_setup",
    "hypre_tpu_torch.parallel.halo",
    "hypre_tpu_torch.parallel.mesh",
    "hypre_tpu_torch.parallel.par_amg",
    "hypre_tpu_torch.parallel.par_csr",
    "hypre_tpu_torch.parallel.par_dia",
    "hypre_tpu_torch.parallel.par_gs",
    "hypre_tpu_torch.parallel.par_struct",
    "hypre_tpu_torch.parallel.par_vector",
    "hypre_tpu_torch.parallel.partition",
    "hypre_tpu_torch.solvers.amg.ads",
    "hypre_tpu_torch.solvers.amg.ame",
    "hypre_tpu_torch.solvers.amg.amgdd",
    "hypre_tpu_torch.solvers.amg.ams",
    "hypre_tpu_torch.solvers.amg.block_amg",
    "hypre_tpu_torch.solvers.amg.boomeramg",
    "hypre_tpu_torch.solvers.amg.coarsen",
    "hypre_tpu_torch.solvers.amg.device_coarsen",
    "hypre_tpu_torch.solvers.amg.euclid",
    "hypre_tpu_torch.solvers.amg.hybrid",
    "hypre_tpu_torch.solvers.amg.ilu",
    "hypre_tpu_torch.solvers.amg.interp",
    "hypre_tpu_torch.solvers.amg.mgr",
    "hypre_tpu_torch.solvers.amg.parasails",
    "hypre_tpu_torch.solvers.amg.pilut",
    "hypre_tpu_torch.solvers.amg.rap",
    "hypre_tpu_torch.solvers.amg.relax",
    "hypre_tpu_torch.solvers.amg.schwarz",
    "hypre_tpu_torch.solvers.amg.smoothed_aggregation",
    "hypre_tpu_torch.solvers.amg.strength",
    "hypre_tpu_torch.solvers.eigen.lobpcg",
    "hypre_tpu_torch.solvers.krylov.bicgstab",
    "hypre_tpu_torch.solvers.krylov.cgnr",
    "hypre_tpu_torch.solvers.krylov.cogmres",
    "hypre_tpu_torch.solvers.krylov.common",
    "hypre_tpu_torch.solvers.krylov.flexgmres",
    "hypre_tpu_torch.solvers.krylov.gmres",
    "hypre_tpu_torch.solvers.krylov.lgmres",
    "hypre_tpu_torch.solvers.krylov.pcg",
    "hypre_tpu_torch.solvers.sstruct_ls",
    "hypre_tpu_torch.solvers.sstruct_ls.fac",
    "hypre_tpu_torch.solvers.sstruct_ls.fac_amr",
    "hypre_tpu_torch.solvers.sstruct_ls.maxwell",
    "hypre_tpu_torch.solvers.sstruct_ls.split",
    "hypre_tpu_torch.solvers.sstruct_ls.sys_pfmg",
    "hypre_tpu_torch.solvers.struct_ls",
    "hypre_tpu_torch.solvers.struct_ls.cyclic_reduction",
    "hypre_tpu_torch.solvers.struct_ls.hybrid",
    "hypre_tpu_torch.solvers.struct_ls.jacobi",
    "hypre_tpu_torch.solvers.struct_ls.pfmg",
    "hypre_tpu_torch.solvers.struct_ls.relax",
    "hypre_tpu_torch.solvers.struct_ls.smg",
    "hypre_tpu_torch.solvers.struct_ls.smg_plane",
    "hypre_tpu_torch.solvers.struct_ls.sparse_msg",
    "hypre_tpu_torch.sstruct",
    "hypre_tpu_torch.sstruct.assemble",
    "hypre_tpu_torch.sstruct.grid",
    "hypre_tpu_torch.sstruct.infile",
    "hypre_tpu_torch.sstruct.matrix",
    "hypre_tpu_torch.sstruct.neighbors",
    "hypre_tpu_torch.sstruct.shared_dof",
    "hypre_tpu_torch.sstruct.vector",
    "hypre_tpu_torch.struct",
    "hypre_tpu_torch.struct.box",
    "hypre_tpu_torch.struct.grid",
    "hypre_tpu_torch.struct.matrix",
    "hypre_tpu_torch.struct.multibox",
    "hypre_tpu_torch.struct.vector",
    "hypre_tpu_torch.utils.errors",
    "hypre_tpu_torch.utils.io",
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


# the JAX package's modules the port does not take: the Pallas kernel
# (csrc/dia_spmv.cu is its counterpart), the transfer helpers and the
# XLA configuration, and the host allocator tuning (left for the port's
# benchmark)
NOT_PORTED = {"ops/pallas_dia.py", "ops/transfer.py", "utils/config.py",
              "utils/malloc_tuning.py"}


def test_every_module_has_its_counterpart():
    jax_pkg = pathlib.Path(REPO) / "hypre_tpu"
    missing = sorted(
        str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")
        if not (pathlib.Path(REPO) / "hypre_tpu_torch"
                / p.relative_to(jax_pkg)).exists())
    assert missing == sorted(NOT_PORTED)
