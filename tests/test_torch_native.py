"""The port's host library builds from the port's own C source, with
the JAX package absent: `hypre_tpu_torch/` alone is copied into a
temporary directory, and a subprocess there builds the library and
runs a 10^3 setup, which must equal this process's bitwise."""

import os
import shutil
import subprocess
import sys

import numpy as np

import hypre_tpu_torch
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions

SLICE = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
             relax_down=18, relax_up=18, embed_level1=False,
             relocate_level2=False, collapse_coarse_n=0)

_PROBE = """
import importlib.util, os
import numpy as np
assert importlib.util.find_spec("hypre_tpu") is None, "hypre_tpu importable"
from hypre_tpu_torch import native
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
native.load()
assert native._SO.startswith(os.getcwd()), native._SO
amg = BoomerAMG(laplacian_7pt(10, 10, 10), BoomerAMGOptions(**%r),
                device="cpu")
np.savez("setup.npz", **{f"{name}{k}": a for k, A in enumerate(amg._host_A)
                         for name, a in (("cf", amg._cf[k]), ("p", A.indptr),
                                         ("i", A.indices), ("x", A.data))})
"""


def test_host_library_builds_without_the_jax_package(tmp_path):
    pkg = os.path.dirname(hypre_tpu_torch.__file__)
    shutil.copytree(pkg, tmp_path / "hypre_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert not (tmp_path / "hypre_tpu").exists()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", _PROBE % (SLICE,)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert (tmp_path / "hypre_tpu_torch" / "_build"
            / "libhypre_host_kernels.so").is_file()
    got = np.load(tmp_path / "setup.npz")
    here = BoomerAMG(laplacian_7pt(10, 10, 10), BoomerAMGOptions(**SLICE),
                     device="cpu")
    assert len(got.files) == 4 * len(here._host_A) >= 12
    for k, A in enumerate(here._host_A):
        for name, a in (("cf", here._cf[k]), ("p", A.indptr),
                        ("i", A.indices), ("x", A.data)):
            assert np.array_equal(got[f"{name}{k}"], a), f"{name}, level {k}"
