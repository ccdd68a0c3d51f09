"""The CUDA kernels (K1, the ELL SpMV, each in its four forms, and the
gathers) on the card against their plain versions (marker `cuda`; each
test skips where torch sees no CUDA device).  This file imports
neither jax nor hypre_tpu, so it runs on a GPU machine without them:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_ragged import ragged

from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, spmv, spmv_axpy, spmv_resid
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.ops.dia_kernel import (
    dia_spmv_cuda, dia_spmv_reference, launch_plan, rows_per_thread,
    vector_path)
from hypre_tpu_torch.ops.ell_kernel import (
    ell_spmv_cuda, ell_spmv_reference, slot_lanes)
from hypre_tpu_torch.ops.forms import FORMS
from hypre_tpu_torch.solvers.amg.relax import jacobi
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
        dia_spmv_cuda(A.data, A.offsets, x.double())
    with pytest.raises(ValueError, match="non-square"):
        dia_spmv_cuda(A.data, A.offsets, torch.ones(215, device=cuda))
    with pytest.raises(ValueError, match="device"):
        dia_spmv_cuda(A.data.cpu(), A.offsets, x)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_cuda(A.data, A.offsets, torch.ones(432, device=cuda)[::2])


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
        ell_spmv_cuda(A.data, A.cols, A.row_len, x.double())
    with pytest.raises(TypeError, match="int32"):
        ell_spmv_cuda(A.data, A.cols.long(), A.row_len, x)
    with pytest.raises(ValueError, match="device"):
        ell_spmv_cuda(A.data.cpu(), A.cols, A.row_len, x)
    with pytest.raises(ValueError, match="contiguous"):
        ell_spmv_cuda(A.data, A.cols, A.row_len, torch.ones(200, device=cuda)[::2])


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


DTYPES = [("float64", torch.float64, 1e-12), ("float32", torch.float32, 1e-5),
          ("bfloat16", torch.float32, 1e-5)]
W = 0.7


def _operands(form, n, dtype, dev, seed):
    """The form's seeded vectors (d > 0, as D^{-1} is)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a).to(dev, dtype)  # noqa: E731
    ops = {"f": t(rng.standard_normal(n)), "u": t(rng.standard_normal(n)),
           "d": t(rng.uniform(0.1, 1.0, n)), "w": W}
    keep = {"plain": (), "resid": ("f",), "axpy": ("u",),
            "jacobi": ("f", "d", "w")}[form]
    return {k: v for k, v in ops.items() if k in keep}


def _rel(y, ref):
    return float((y - ref).abs().max() / ref.abs().max())


def _tall(n, m, seed):
    """n x m with 1-4 entries a row (duplicates summed), built in bulk."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 5, n)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, m, len(rows))
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, m))


ELL_SHAPES = {  # (matrix, slot lanes the wrapper picks)
    "square": (functools.partial(ragged, 5000, 5000, 37, 1), 16),
    "tall": (functools.partial(ragged, 20000, 6000, 4, 2), 4),
    "wide": (functools.partial(ragged, 6000, 20000, 35, 3), 16),
    # one lane a row; 300,001 rows, not a multiple of 32
    "tall S=1": (functools.partial(_tall, 300_001, 80_000, 4), 1),
    # two lanes a row: too few rows to fill the card one thread a row
    "tall S=2": (functools.partial(_tall, 150_000, 40_000, 6), 2),
    "square S=8": (functools.partial(ragged, 40_000, 40_000, 20, 5), 8),
}
# each shape at the wrapper's pick (None) and, for the small three, at
# one lane and at 16 lanes a row
ELL_CASES = ([(shape, None) for shape in ELL_SHAPES]
             + [(shape, s) for shape in ("square", "tall", "wide")
                for s in (1, 16)])


@functools.lru_cache(maxsize=None)
def _ell_matrix(shape):
    return ELL_SHAPES[shape][0]()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lanes", ELL_CASES)
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_ell_forms_match_plain_on_card(cuda, shape, lanes, form, dtype,
                                       xdtype, tol):
    M = _ell_matrix(shape)
    n, m = M.shape
    if form == "jacobi" and n != m:
        pytest.skip("jacobi is for square operators")
    A = CSRMatrix.from_scipy(M).to_ell(dtype, cuda)
    if lanes is None:
        assert slot_lanes(A.data.shape[0], n) == ELL_SHAPES[shape][1]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(m)
                         ).to(cuda, xdtype)
    ops = _operands(form, n, xdtype, cuda, seed=n)
    before = ell_spmv_cuda.launches
    y = ell_spmv_cuda(A.data, A.cols, A.row_len, x, form, lanes=lanes, **ops)
    assert ell_spmv_cuda.launches == before + 1
    ref = ell_spmv_reference(A.data, A.cols, x, form, **ops)
    torch.cuda.synchronize()
    assert y.shape == (n,) and y.dtype == xdtype
    assert _rel(y, ref) <= tol


def _banded(n, offsets, seed):
    """Random diagonals, out-of-range taps left nonzero in the data:
    only the kernel's bounds check keeps them out."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((len(offsets), n))


DIA_CASES = {  # (data maker, offsets, vector path taken)
    # 7-point, n = 2431 is no multiple of R: the scalar path
    "7pt scalar": "17,13,11",
    # 7-point, n = 4096: 16-byte path, edge rows [0, 256) and [3840, n)
    "7pt vector": "16,16,16",
    # 12 random offsets: the device-array path, vector and scalar
    "12 offsets vector": 4000,
    "12 offsets scalar": 4001,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(DIA_CASES))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_k1_forms_match_plain_on_card(cuda, case, form, dtype, xdtype, tol):
    spec = DIA_CASES[case]
    if isinstance(spec, str):
        A = csr_to_dia(laplacian_7pt(*map(int, spec.split(","))), dtype, cuda)
        data, offsets, n = A.data, A.offsets, A.num_rows
    else:
        n = spec
        offsets = tuple(int(o) for o in np.unique(
            np.random.default_rng(7).integers(-300, 300, 12)))
        data = torch.from_numpy(_banded(n, offsets, 8)).to(
            cuda, getattr(torch, dtype))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)
                         ).to(cuda, xdtype)
    assert vector_path(n, data, x) == (n % rows_per_thread(data) == 0)
    assert vector_path(n, data, x) == case.endswith("vector")
    ops = _operands(form, n, xdtype, cuda, seed=n)
    before = dia_spmv_cuda.launches
    y = dia_spmv_cuda(data, offsets, x, form, **ops)
    assert dia_spmv_cuda.launches == before + 1
    ref = dia_spmv_reference(data, offsets, x, form, **ops)
    torch.cuda.synchronize()
    assert _rel(y, ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xdtype,tol", [
    ("float32", torch.float32, 1e-5), ("bfloat16", torch.float32, 1e-5)])
def test_k1_past_32_bit_indices(cuda, dtype, xdtype, tol):
    """7 offsets with noff * n past 2^31: by value, 64-bit indices (8.6
    GB of f32 diagonals).  Held against the plain version on the edge
    rows at both ends and on an interior window."""
    offsets = (-9216, -96, -1, 0, 1, 96, 9216)
    n = 2**31 // len(offsets) + 1000
    assert launch_plan(n, offsets) == (True, True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    data = torch.randn(len(offsets), n, device=cuda, generator=gen
                       ).to(getattr(torch, dtype))
    x = torch.randn(n, device=cuda, dtype=xdtype, generator=gen)
    y = dia_spmv_cuda(data, offsets, x)
    pad = max(offsets)
    for lo in (0, n // 2 - 5000, n - 20_000):
        hi = min(lo + 20_000, n)
        a, b = max(lo - pad, 0), min(hi + pad, n)  # x rows the window reads
        # the window's rows as a square problem on x[a:b]: each of their
        # taps stays in [a, b) or leaves [0, n) as well
        sub = data[:, a:b].contiguous()
        ref = dia_spmv_reference(sub, offsets, x[a:b].contiguous())
        ref = ref[lo - a: hi - a]
        assert _rel(y[lo:hi], ref) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_jacobi_residual_prolongation_are_one_launch(cuda, fmt):
    """relax.jacobi, spmv_resid and spmv_axpy: one kernel launch each,
    and no tensor besides the result (the unfused ops made one per
    elementwise step)."""
    if fmt == "dia":
        A = csr_to_dia(laplacian_7pt(16, 16, 16), "float64", cuda)
        P, counted = A, dia_spmv_cuda
    else:
        A = CSRMatrix.from_scipy(ragged(5000, 5000, 37, 1)).to_ell("float64", cuda)
        P = CSRMatrix.from_scipy(ragged(5000, 2000, 4, 2)).to_ell("float64", cuda)
        counted = ell_spmv_cuda
    rng = np.random.default_rng(0)
    v = lambda k: torch.from_numpy(rng.standard_normal(k)).to(cuda)  # noqa: E731
    n = A.num_rows
    u, f, d, e = v(n), v(n), v(n).abs(), v(P.num_cols)
    for fn in (lambda: jacobi(A, d, u, f, W), lambda: spmv_resid(A, u, f),
               lambda: spmv_axpy(P, e, u)):
        fn()  # the first call builds the library
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        before = counted.launches
        fn()
        assert counted.launches == before + 1
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs + 1
