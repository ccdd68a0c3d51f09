"""The CUDA kernels (K1, the ELL SpMV, the gathers) on the card against
their plain versions (marker `cuda`; each test skips where torch sees
no CUDA device).  This file imports neither jax nor hypre_tpu, so it
runs on a GPU machine without them:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch
from torch_ragged import ragged

from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, spmv
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda, ell_spmv_reference
from hypre_tpu_torch.ops.gather_kernel import (
    flat_take_cuda, flat_take_reference, take_along_axis_cuda,
    take_along_axis_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xdtype,tol", [
    ("float64", torch.float64, 1e-12),
    ("float32", torch.float32, 1e-5),
    ("bfloat16", torch.float32, 1e-5),
])
def test_k1_matches_plain_on_card(cuda, dtype, xdtype, tol):
    A = csr_to_dia(laplacian_7pt(17, 13, 11), dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(A.num_rows)
                         ).to(cuda, xdtype)
    before = dia_spmv_cuda.launches
    y = spmv(A, x)
    assert dia_spmv_cuda.launches == before + 1
    ref = dia_spmv_reference(A.data, A.offsets, x)
    assert float((y - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda):
    A = csr_to_dia(laplacian_7pt(6, 6, 6), "float32", cuda)
    x = torch.ones(216, device=cuda)
    with pytest.raises(TypeError):
        dia_spmv_cuda(A.data, A.offsets_t, x.double())
    with pytest.raises(ValueError, match="non-square"):
        dia_spmv_cuda(A.data, A.offsets_t, torch.ones(215, device=cuda))
    with pytest.raises(ValueError, match="device"):
        dia_spmv_cuda(A.data.cpu(), A.offsets_t, x)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_cuda(A.data, A.offsets_t, torch.ones(432, device=cuda)[::2])


def _ragged_ell(n, m, width, dtype, dev, seed):
    """An n x m ELL with 1..width entries a row (one row full)."""
    return CSRMatrix.from_scipy(ragged(n, m, width, seed)).to_ell(dtype, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,width", [(5000, 5000, 37), (20000, 6000, 4),
                                       (6000, 20000, 35)],
                         ids=["square", "tall", "wide"])
@pytest.mark.parametrize("dtype,xdtype,tol", [
    ("float64", torch.float64, 1e-12),
    ("float32", torch.float32, 1e-5),
    ("bfloat16", torch.float32, 1e-5),
])
def test_ell_kernel_matches_plain_on_card(cuda, n, m, width, dtype, xdtype,
                                          tol):
    A = _ragged_ell(n, m, width, dtype, cuda, seed=n + m)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(m)
                         ).to(cuda, xdtype)
    before = ell_spmv_cuda.launches
    y = spmv(A, x)
    assert ell_spmv_cuda.launches == before + 1
    assert y.shape == (n,) and y.dtype == xdtype
    ref = ell_spmv_reference(A.data, A.cols, x)
    torch.cuda.synchronize()
    assert float((y - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.cuda
def test_ell_kernel_rejects_what_it_does_not_take(cuda):
    A = _ragged_ell(300, 100, 4, "float32", cuda, seed=1)
    x = torch.ones(100, device=cuda)
    with pytest.raises(TypeError):
        ell_spmv_cuda(A.data, A.cols, x.double())
    with pytest.raises(TypeError, match="int32"):
        ell_spmv_cuda(A.data, A.cols.long(), x)
    with pytest.raises(ValueError, match="device"):
        ell_spmv_cuda(A.data.cpu(), A.cols, x)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv_cuda(A.data, A.cols, torch.ones(200, device=cuda)[::2])


@pytest.mark.cuda
def test_gathers_match_plain_on_card_bitwise(cuda):
    """The probes' shapes: K2 (a)/(b)/(c) and K3."""
    rng = np.random.default_rng(0)
    x2 = torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    iL = torch.from_numpy(rng.integers(0, 512, (64, 512)).astype(np.int32))
    iS = torch.from_numpy(rng.integers(0, 64, (64, 512)).astype(np.int32))
    xf = torch.from_numpy(rng.standard_normal(128 * 1024).astype(np.float32))
    iF = torch.from_numpy(rng.integers(0, xf.numel(), (64, 512)).astype(np.int32))
    xb = torch.from_numpy(rng.standard_normal((512, 512)).astype(np.float32))
    ib = torch.from_numpy(rng.integers(0, 512, (4096, 512)).astype(np.int32))
    for x, i, axis in ((x2, iL, 1), (x2, iS, 0), (xb, ib, 1)):
        x, i = x.to(cuda), i.to(cuda)
        assert torch.equal(take_along_axis_cuda(x, i, axis),
                           take_along_axis_reference(x, i, axis))
    xf, iF = xf.to(cuda), iF.to(cuda)
    assert torch.equal(flat_take_cuda(xf, iF), flat_take_reference(xf, iF))


@pytest.mark.cuda
def test_gathers_reject_what_they_do_not_take(cuda):
    x = torch.ones(64, 512, device=cuda)
    i = torch.zeros(64, 512, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        take_along_axis_cuda(x.double(), i, 1)
    with pytest.raises(TypeError):
        flat_take_cuda(x.reshape(-1), i.long())
    with pytest.raises(ValueError, match="device"):
        take_along_axis_cuda(x, i.cpu(), 1)
    with pytest.raises(ValueError, match="tile"):
        take_along_axis_cuda(x, i[:63], 1)
    with pytest.raises(ValueError, match="1-D"):
        flat_take_cuda(x, i)
