"""The port's host library builds from the port's own C source, with
the JAX package absent: `hypre_tpu_torch/` alone is copied into a
temporary directory, and a subprocess there builds the library and
runs a 10^3 setup, which must equal this process's bitwise.  Every
function of that source is byte for byte the JAX package's."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

import hypre_tpu_torch
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_C = os.path.join(REPO, "hypre_tpu_torch", "csrc", "host_kernels.c")
JAX_C = os.path.join(REPO, "hypre_tpu", "native", "kernels.c")


def c_functions(path: str) -> dict:
    """{name: text} of the functions defined at the top level of a C
    file, from the line that opens the definition to its closing brace
    at column 0."""
    lines = open(path).read().split("\n")
    out, i = {}, 0
    while i < len(lines):
        m = re.match(r"^(?:static\s+)?(?:inline\s+)?[A-Za-z_][\w\s*]*?\b(\w+)\s*\(",
                     lines[i])
        if m and not lines[i].rstrip().endswith(";"):
            j = lines.index("}", i)
            out[m.group(1)] = "\n".join(lines[i:j + 1])
            i = j + 1
        else:
            i += 1
    return out


PORT_FUNCTIONS = sorted(c_functions(PORT_C))


def test_port_c_defines_the_setup_kernels():
    assert {"rs_coarsen", "cljp_coarsen", "pmis_loop",
            "strength_classical_i32", "iluk_factor",
            "ilut_factor"} <= set(PORT_FUNCTIONS)


@pytest.mark.parametrize("name", PORT_FUNCTIONS)
def test_port_c_function_is_the_jax_packages(name):
    assert c_functions(PORT_C)[name] == c_functions(JAX_C)[name]


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
