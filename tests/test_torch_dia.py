"""K1's plain version and the port's formats against the JAX package.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
in interpret mode, the f64 DIA SpMV through its XLA shift path.  The
port's `dia_spmv` takes the plain version on CPU tensors, so these
tests also pin that no CPU call launches K1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.ops.csr import CSRMatrix as JCSR
from hypre_tpu.ops.dia import DIAMatrix as JDIA
from hypre_tpu.ops.dia import csr_to_dia as jax_csr_to_dia
from hypre_tpu.ops.dia import dia_spmv as jax_dia_spmv
from hypre_tpu.ops.dia import freeze_auto as jax_freeze_auto
from hypre_tpu.ops.pallas_dia import pallas_dia_spmv
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, spmv
from hypre_tpu_torch.ops.dia import DIAMatrix, csr_to_dia, freeze_auto
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions


def banded(n, offsets, seed):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for o in offsets:
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
        vals.append(rng.standard_normal(len(i)))
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n))


def rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def _port_dia(jA):
    """The port's DIA with the JAX operator's values (padding sliced)."""
    n = jA.num_rows
    data = np.array(jA.data[:, :n])  # writable copy
    if data.dtype.name == "bfloat16":
        t = torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(data)
    return DIAMatrix(data=t, offsets=jA.offsets, num_rows=n, num_cols=n)


@pytest.mark.parametrize("offsets,dtype,tol", [
    ((-320, -1, 0, 1, 320), "float32", 3e-6),
    ((0, 3, 7, 100), "float32", 3e-6),
    # bf16 diagonals with f32 vectors: both widen the same bf16 values
    ((-320, -1, 0, 1, 320), "bfloat16", 1e-6),
])
def test_reference_matches_pallas_interpret(offsets, dtype, tol):
    n = 20000
    M = banded(n, offsets, seed=7)
    jA = jax_csr_to_dia(JCSR.from_scipy(M),
                        dtype=jnp.bfloat16 if dtype == "bfloat16" else np.float32)
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    y_jax = pallas_dia_spmv(jA, jnp.asarray(x), interpret=True)
    y = dia_spmv_reference(_port_dia(jA).data, jA.offsets, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert rel_err(y, y_jax) <= tol


def test_reference_matches_pallas_interpret_wide():
    """130 random offsets (> the Pallas kernel's 64-offset chunk)."""
    rng = np.random.default_rng(7)
    n = 4096
    offs = np.unique(rng.integers(-400, 400, 130))
    data = rng.standard_normal((len(offs), n)).astype(np.float32)
    rows = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (rows + o < 0) | (rows + o >= n)] = 0.0
    offsets = tuple(int(o) for o in offs)
    jA = JDIA(data=jnp.asarray(data), offsets=offsets, num_rows=n, num_cols=n)
    x = rng.standard_normal(n).astype(np.float32)
    y_jax = pallas_dia_spmv(jA, jnp.asarray(x), interpret=True)
    y = dia_spmv_reference(torch.from_numpy(data), offsets, torch.from_numpy(x))
    assert rel_err(y, y_jax) <= 3e-6


@pytest.mark.parametrize("nx", [5, 24])
def test_f64_dia_matches_jax(nx):
    """Port CSR -> DIA conversion and SpMV against the JAX package's
    f64 path, on the 7-point operator."""
    A = laplacian_7pt(nx, nx, nx)
    D = csr_to_dia(A, "float64", "cpu")
    jA = jax_csr_to_dia(jax_laplacian_7pt(nx, nx, nx), device=False)
    assert D.offsets == jA.offsets
    assert np.array_equal(D.data.numpy(), np.asarray(jA.data)[:, :nx**3])
    x = np.random.default_rng(nx).standard_normal(nx**3)
    y = spmv(D, torch.from_numpy(x))
    assert rel_err(y, jax_dia_spmv(jA, jnp.asarray(x))) <= 1e-12
    assert rel_err(y, A.to_scipy() @ x) <= 1e-12


@pytest.mark.parametrize("nx", [24, 48])
def test_freeze_auto_formats_match_jax(nx):
    """Both packages freeze every level of the hierarchy into the same
    format with the same values (24^3: DIA then dense; 48^3 adds ELL)."""
    opts = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False,
        relocate_level2=False, collapse_coarse_n=0)
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), opts, device="cpu")
    kinds = []
    for k, A in enumerate(amg._host_A):
        mine = freeze_auto(CSRMatrix.from_scipy(A), "float64", "cpu")
        ref = jax_freeze_auto(JCSR.from_scipy(A), dtype=np.float64, device=False)
        kinds.append(type(mine).__name__)
        assert type(mine).__name__ == type(ref).__name__
        n, m = A.shape
        if kinds[-1] == "DIAMatrix":
            assert mine.offsets == ref.offsets
            assert np.array_equal(mine.data.numpy(), ref.data[:, :n])
        elif kinds[-1] == "ELLMatrix":
            assert np.array_equal(mine.cols.numpy(), ref.cols[:, :n])
            assert np.array_equal(mine.data.numpy(), ref.data[:, :n])
        else:
            assert np.array_equal(mine.data.numpy(), ref.data)
        assert np.array_equal(amg.levels[k].A.data.numpy(), mine.data.numpy())
    assert kinds[0] == "DIAMatrix" and kinds[-1] == "DenseMatrix"
    if nx == 24:
        assert kinds[1:] == ["DenseMatrix"] * (len(kinds) - 1)
    else:
        assert "ELLMatrix" in kinds


def test_cpu_tensors_never_launch_k1():
    dia_spmv_cuda.launches = 0
    A = csr_to_dia(laplacian_7pt(6, 6, 6), "float32", "cpu")
    x = torch.ones(216, dtype=torch.float32)
    y = spmv(A, x)
    assert y.shape == (216,)
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmv_cuda(A.data, A.offsets, x)
    assert dia_spmv_cuda.launches == 0


def test_dia_is_square_and_exact_width():
    A = csr_to_dia(laplacian_7pt(4, 3, 2), "bfloat16", "cpu")
    assert A.data.shape == (7, 24) and A.data.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="square"):
        csr_to_dia(CSRMatrix.from_scipy(sp.random(4, 5, density=0.5, format="csr")),
                   "float64", "cpu")
