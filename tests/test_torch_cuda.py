"""K1 on the card against its plain version (marker `cuda`; each test
skips where torch sees no CUDA device).  This file imports neither jax
nor hypre_tpu, so it runs on a GPU machine without them:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference


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
