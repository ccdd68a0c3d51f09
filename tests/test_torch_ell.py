"""The port's ELL SpMV against the JAX package's.

Operators are built on the JAX side (`CSRMatrix.to_ell`, slot-major
`transposed` layout), carried into the port with `convert`, and both
packages multiply the same seeded vector: `hypre_tpu/ops/spmv.py::ell_spmv`
against the port's plain version, which `ell_spmv` takes for CPU
tensors.  The shapes are those of the V-cycle's operators: square (A),
tall (P, at most 4 entries a row) and wide (R, up to 35).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ragged import ragged

from hypre_tpu.ops.csr import CSRMatrix as JCSR
from hypre_tpu.ops.spmv import ell_spmv as jax_ell_spmv
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.ops import CSRMatrix, ELLMatrix, spmv
from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda, ell_spmv_reference
from hypre_tpu_torch.ops.spmv import ell_spmv
from torch_threads import one_thread  # noqa: F401

SHAPES = {"square": (3000, 3000, 37), "tall": (2000, 700, 4),
          "wide": (700, 2000, 35)}


def carried_ell(M, dtype):
    """The JAX package's device-layout ELL of M (numpy leaves) and the
    port's ELLMatrix carried from it by `convert`."""
    jA = JCSR.from_scipy(M).to_ell(dtype=dtype, device=False, transposed=True)
    n = M.shape[0]
    lvl = SimpleNamespace(A=jA, dinv=np.ones(n), l1inv=np.ones(n),
                          cmask=np.ones(n, dtype=bool), P=None, R=None,
                          coarse_inv=None)
    return jA, levels_from_numpy([lvl], "cpu")[0].A


def rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype,xdtype,tol", [
    (np.float64, np.float64, 1e-12),
    # bf16 data with f32 x: both widen the same bf16 values
    (jnp.bfloat16, np.float32, 1e-6),
])
def test_plain_ell_matches_jax(shape, dtype, xdtype, tol):
    n, m, width = SHAPES[shape]
    M = ragged(n, m, width, seed=n + m)
    jA, A = carried_ell(M, dtype)
    assert isinstance(A, ELLMatrix) and A.data.shape == (width, n)
    assert (A.num_rows, A.num_cols, A.nnz) == (n, m, M.nnz)
    x = np.random.default_rng(1).standard_normal(m).astype(xdtype)
    y_jax = jax_ell_spmv(jA, jnp.asarray(x))[:n]
    y = spmv(A, torch.from_numpy(x))
    assert y.shape == (n,) and y.dtype == torch.from_numpy(x).dtype
    assert rel_err(y, y_jax) <= tol
    if dtype == np.float64:
        assert rel_err(y, M @ x) <= 1e-12


@pytest.mark.parametrize("shape", list(SHAPES))
def test_port_to_ell_matches_jax_layout(shape):
    """The port's own freeze gives the JAX layout, cols for cols."""
    n, m, width = SHAPES[shape]
    M = ragged(n, m, width, seed=7)
    jA, carried = carried_ell(M, np.float64)
    mine = CSRMatrix.from_scipy(M).to_ell("float64", "cpu")
    assert np.array_equal(mine.cols.numpy(), carried.cols.numpy())
    assert np.array_equal(mine.data.numpy(), carried.data.numpy())


def test_carried_ell_meets_the_kernel_contract():
    _, A = carried_ell(ragged(300, 100, 4, seed=3), jnp.bfloat16)
    assert A.cols.dtype == torch.int32 and A.data.dtype == torch.bfloat16
    assert A.cols.is_contiguous() and A.data.is_contiguous()


def test_ell_matrix_rejects_what_the_kernel_does_not_take():
    cols = torch.zeros(3, 10, dtype=torch.int32)
    data = torch.zeros(3, 10, dtype=torch.float64)
    with pytest.raises(TypeError, match="int32"):
        ELLMatrix(cols=cols.long(), data=data, num_rows=10, num_cols=4, nnz=0)
    with pytest.raises(ValueError, match="contiguous"):
        ELLMatrix(cols=cols.t().contiguous().t(), data=data.t().contiguous().t(),
                  num_rows=10, num_cols=4, nnz=0)
    with pytest.raises(ValueError, match=r"\[width, 9\]"):
        ELLMatrix(cols=cols, data=data, num_rows=9, num_cols=4, nnz=0)


def test_cpu_tensors_never_launch_the_ell_kernel():
    ell_spmv_cuda.launches = 0
    A = CSRMatrix.from_scipy(ragged(50, 20, 4, seed=5)).to_ell("float32", "cpu")
    x = torch.ones(20, dtype=torch.float32)
    y = ell_spmv(A, x)
    assert y.shape == (50,)
    assert torch.equal(y, ell_spmv_reference(A.data, A.cols, x))
    with pytest.raises(ValueError, match="CUDA"):
        ell_spmv_cuda(A.data, A.cols, A.row_len, x)
    with pytest.raises(ValueError, match="x has shape"):
        ell_spmv(A, torch.ones(50, dtype=torch.float32))
    assert ell_spmv_cuda.launches == 0
