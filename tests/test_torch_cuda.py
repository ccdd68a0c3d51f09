"""The CUDA kernels (K1, the ELL SpMV, each in its four forms, K1 with a
COO tail in its launch, the gathers, the COO tail, the cell-dense
kernel and the Gauss-Seidel sweep in its sync-free and wavefront forms)
and the lattice operators that run
on them, on
the card against their plain versions, and the device RAP's pass and
the device setup chain on the card against the same on the CPU (marker
`cuda`; each
test skips where torch sees no CUDA device).  This file imports
neither jax nor hypre_tpu, so it runs on a GPU machine without them:
    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools
import zlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_ragged import ragged

from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix, spmv, spmv_axpy, spmv_resid
from hypre_tpu_torch.ops import dia as tdia
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.ops.dia_kernel import (
    dia_spmv_cuda, dia_spmv_reference, launch_plan, offset_lanes,
    rows_per_thread, vector_path)
from hypre_tpu_torch.ops.ell_kernel import (
    ell_spmv_cuda, ell_spmv_reference, slot_lanes)
from hypre_tpu_torch.ops.forms import FORMS
from hypre_tpu_torch.solvers.amg.relax import jacobi
from hypre_tpu_torch.ops.gather_kernel import (
    flat_plan, flat_take_cuda, flat_take_reference, take_along_axis_cuda,
    take_along_axis_reference, take_plan)
from hypre_tpu_torch.ops.tail_kernel import coo_tail_cuda, coo_tail_reference
from hypre_tpu_torch.ops.cell_dense_kernel import (
    cell_dense_cuda, cell_dense_reference)
from hypre_tpu_torch.ops.forms import epilogue
from test_torch_gather import TAKE_CASES, take_inputs


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
    with pytest.raises(ValueError, match="CUDA"):
        take_along_axis_cuda(x.cpu(), i, 1)
    with pytest.raises(ValueError, match="tile"):
        take_along_axis_cuda(x, i[:, :100].contiguous(), 0, form="elementwise")
    with pytest.raises(ValueError, match="form"):
        flat_take_cuda(x.reshape(-1), i, form="rowwise")


def _seed(*parts) -> int:
    """A seed of each case's own, so that no earlier case's output (or its
    reference), left in a block the allocator hands a kernel, holds the
    answer: an output element the kernel leaves unwritten then shows."""
    return zlib.crc32(repr(parts).encode())


def _poison(n: int, dtype, dev) -> None:
    """Fill a block of n elements with NaN and free it, just before a
    kernel allocates its output of that size."""
    torch.full((n,), float("nan"), dtype=dtype, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("form,batch", [("elementwise", None), ("tiled", None),
                                        ("tiled", 1), ("tiled", 8)])
@pytest.mark.parametrize("case", TAKE_CASES)
def test_take_along_axis_forms_on_card_bitwise(cuda, case, form, batch):
    """Both forms, one launch each, bitwise the plain version on the
    probes' shapes, ragged, narrow and tall shapes, and every instance of
    the tiled form (x's part in shared memory, or through L2 when too
    wide; one quad or eight a thread in flight)."""
    xs, ish, axis, instance = TAKE_CASES[case]
    plan = take_plan(xs, ish, axis, batch=batch)
    assert plan.instance == instance
    x, i = (torch.from_numpy(a).to(cuda) for a in take_inputs(
        xs, ish, axis, _seed(case, form, batch)))
    _poison(i.numel(), x.dtype, cuda)
    before = take_along_axis_cuda.launches
    out = take_along_axis_cuda(x, i, axis, form=form,
                               plan=plan if form == "tiled" else None)
    assert take_along_axis_cuda.launches == before + 1
    assert torch.equal(out, take_along_axis_reference(x, i, axis))


def _unaligned(a: np.ndarray, dev):
    """a on the card 4 bytes past a 16-byte boundary, contiguous."""
    buf = torch.empty(a.size + 1, dtype=getattr(torch, str(a.dtype)), device=dev)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["K2a-lanes", "K2b-sublanes", "ic%4=1",
                                  "axis0-ic=2xc-aligned"])
def test_take_along_axis_unaligned_pointers_on_card(cuda, case):
    """x and idx off the 16-byte boundary: the tiled form moves scalars."""
    xs, ish, axis, _ = TAKE_CASES[case]
    x, i = (_unaligned(a, cuda) for a in take_inputs(
        xs, ish, axis, _seed(case, "unaligned")))
    assert x.data_ptr() % 16 and i.data_ptr() % 16
    _poison(i.numel(), x.dtype, cuda)
    assert torch.equal(take_along_axis_cuda(x, i, axis),
                       take_along_axis_reference(x, i, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("form,blocks", [
    ("elementwise", None), ("tiled", None), ("tiled", 132 * 8),
    ("tiled", 1)])
@pytest.mark.parametrize("n", [32_768, 1_529, 1_731, 7, 1_000_003])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_flat_take_forms_on_card_bitwise(cuda, n, dtype, form, blocks):
    """K2 (c), the lattice path's shapes, ragged counts and more than the
    resident grid's threads, each form, the tiled one on the plan's grid
    and on fewer blocks (a thread walks several elements); idx aligned
    and not, each with indices of its own."""
    rng = np.random.default_rng(_seed(n, dtype, form, blocks))
    table = torch.from_numpy(rng.standard_normal(131_072).astype(dtype)).to(cuda)
    plan = flat_plan(n, blocks=blocks) if form == "tiled" else None
    for place in (lambda a: torch.from_numpy(a).to(cuda),
                  lambda a: _unaligned(a, cuda)):
        i = place(rng.integers(0, 131_072, size=n).astype(np.int32))
        _poison(n, table.dtype, cuda)
        before = flat_take_cuda.launches
        out = flat_take_cuda(table, i, form=form, plan=plan)
        assert flat_take_cuda.launches == before + 1
        assert torch.equal(out, flat_take_reference(table, i))


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


# -- the lattice forms: the COO tail, GatherOp on flat_take, the parity
# -- operators on K1 ----------------------------------------------------

def _tail_entries(seed, n_rows, n_cols, nnz):
    """COO entries; three rows hold 300 entries each, most a few."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, size=nnz)
    rows[:900] = np.repeat(rng.choice(n_rows, 3, False), 300)
    return (rows.astype(np.int64), rng.integers(0, n_cols, size=nnz),
            rng.standard_normal(nnz))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,n_cols,nnz", [(110_592, 884_736, 60_000),
                                               (900, 700, 4000)])
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_coo_tail_matches_plain_on_card(cuda, n_rows, n_cols, nnz, dtype,
                                        xdtype, tol):
    T = tdia._build_tail(*_tail_entries(nnz, n_rows, n_cols, nnz), dtype, cuda)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(n_cols)).to(cuda, xdtype)
    y0 = torch.from_numpy(rng.standard_normal(n_rows)).to(cuda, xdtype)
    before = coo_tail_cuda.launches
    y = tdia.tail_apply(T, x, y0.clone())
    assert coo_tail_cuda.launches == before + 1
    ref = coo_tail_reference(T.vals, T.cols, T.seg_ptr, T.rows_u, x, y0.clone())
    torch.cuda.synchronize()
    assert _rel(y, ref) <= tol
    # no atomics: the same bits on every run
    assert torch.equal(tdia.tail_apply(T, x, y0.clone()), y)
    # against the CPU's plain version, which sums each row in stored order
    cpu = coo_tail_reference(T.vals.cpu(), T.cols.cpu(), T.seg_ptr.cpu(),
                             T.rows_u.cpu(), x.cpu(), y0.cpu())
    assert _rel(y.cpu(), cpu) <= tol


@pytest.mark.cuda
def test_coo_tail_rejects_what_it_does_not_take(cuda):
    T = tdia._build_tail(*_tail_entries(2, 900, 700, 4000), "float32", cuda)
    x, y = torch.ones(700, device=cuda), torch.zeros(900, device=cuda)
    args = (T.vals, T.cols, T.seg_ptr, T.rows_u)
    with pytest.raises(TypeError, match="unsupported"):
        coo_tail_cuda(T.vals.double(), *args[1:], x, y)
    with pytest.raises(TypeError, match="int32"):
        coo_tail_cuda(T.vals, T.cols.long(), *args[2:], x, y)
    with pytest.raises(ValueError, match="device"):
        coo_tail_cuda(*args, x, y.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        coo_tail_cuda(*args, torch.ones(1400, device=cuda)[::2], y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_gather_op_runs_flat_take_on_card(cuda, dtype, xdtype, tol):
    """GatherOp's x[pos] is one flat_take launch, f32 or f64, bitwise
    the plain take; ScatterOp(GatherOp(dense)) is the relocated dense
    level and the collapsed coarse operator."""
    rng = np.random.default_rng(12)
    n_out, k = 13_824, 1500
    pos = np.sort(rng.choice(n_out, size=k, replace=False))
    D = tdia.DenseMatrix(torch.from_numpy(rng.standard_normal((k, k))).to(
        cuda, getattr(torch, dtype)), k, k)
    p32 = torch.from_numpy(pos.astype(np.int32)).to(cuda)
    p64 = torch.from_numpy(pos).to(cuda)
    x = torch.from_numpy(rng.standard_normal(n_out)).to(cuda, xdtype)
    before = flat_take_cuda.launches
    taken = flat_take_cuda(x, p32)
    assert torch.equal(taken, flat_take_reference(x, p32))
    A = tdia.ScatterOp(tdia.GatherOp(D, p32), p64, n_out)
    y = spmv(A, x)
    assert flat_take_cuda.launches == before + 2
    assert tdia.kernel_launches(A) == {"flat_take": 1}
    ref = torch.zeros(n_out, dtype=xdtype, device=cuda)
    ref[p64] = D.data.to(xdtype) @ x[p64]
    assert _rel(y, ref) <= max(tol, 1e-4 if dtype == "bfloat16" else 0)
    off = torch.ones(n_out, dtype=torch.bool, device=cuda)
    off[p64] = False
    assert not bool(y[off].any())


def _parity_problem(seed=5):
    """An interpolation-like M (fine lattice rows, point columns near the
    row) on a 32^3 lattice coarsened by (1, 2, 2)."""
    rng = np.random.default_rng(seed)
    shape, factors = (32, 32, 32), (1, 2, 2)
    nf, npts = 32**3, 4000
    pts_pos = np.sort(rng.choice(nf, size=npts, replace=False))
    ccol = tdia.relocate_to_cells(pts_pos, shape, factors)
    rows = rng.integers(0, nf, size=24_000)
    near = np.clip(np.searchsorted(pts_pos, rows), 0, npts - 1)
    cols = np.clip(near + rng.integers(-1, 2, size=rows.size), 0, npts - 1)
    M = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(nf, npts))
    M.sum_duplicates()
    xc = np.zeros(32 * 16 * 16)
    xc[ccol] = rng.standard_normal(npts)
    return shape, factors, ccol, M, xc, rng.standard_normal(nf)


@pytest.mark.cuda
@pytest.mark.parametrize("tail_min", [0, 6])
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_parity_operators_run_k1_on_card(cuda, tail_min, dtype, xdtype, tol):
    """ParityInterpOp: one K1 launch a non-empty parity matrix into the
    [B, ncells] buffer, each carrying its class's share of the tail;
    ParityRestrictOp: the same count, chained through K1's axpy form,
    its tail on the first launch; no coo_tail launch.  Held against the
    same operators on the CPU (the plain versions), and in f64 against
    the composition the fused tail replaced (bitwise for the interp,
    1e-13 for the restriction, whose tail is summed first)."""
    shape, factors, ccol, M, xc, xf = _parity_problem()
    for build, Mx, xin in ((tdia.build_parity_interp, M, xc),
                           (tdia.build_parity_restrict, M.T.tocsr(), xf)):
        A = build(Mx, ccol, shape, factors, dtype, cuda, tail_min=tail_min)
        C = build(Mx, ccol, shape, factors, dtype, "cpu", tail_min=tail_min)
        assert (A.tail is not None) == bool(tail_min)
        want = tdia.kernel_launches(A)
        assert want["dia_spmv"] == sum(1 for m in A.mats if m.offsets) == 4
        assert "coo_tail" not in want
        # more than 8 offsets somewhere: K1's device-array path
        assert max(len(m.offsets) for m in A.mats) > 8
        counts = (dia_spmv_cuda.launches, coo_tail_cuda.launches,
                  dia_spmv_cuda.tail_launches)
        x = torch.from_numpy(xin).to(xdtype)
        y = spmv(A, x.to(cuda))
        assert dia_spmv_cuda.launches == counts[0] + want["dia_spmv"]
        assert coo_tail_cuda.launches == counts[1]
        assert dia_spmv_cuda.tail_launches == counts[2] + want.get(
            "dia_spmv_tail", 0)
        assert y.is_contiguous() and y.shape == (A.num_rows,)
        assert _rel(y.cpu(), spmv(C, x)) <= tol
        assert torch.equal(spmv(A, x.to(cuda)), y)  # a fixed order
        if tail_min and dtype == "float64":
            old = tdia.spmv_tail_after(A, x.to(cuda))
            if build is tdia.build_parity_interp:
                assert torch.equal(y, old)
            else:
                assert _rel(y, old) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_dia_with_tail_runs_k1_and_coo_tail_on_card(cuda, dtype, xdtype, tol):
    """An embedded operator with hundreds of offsets and a tail: one K1
    launch (offsets through the device array) that carries the tail, in
    every form, and no coo_tail launch; in f64 bitwise K1, then
    coo_tail, then the torch epilogue."""
    rng = np.random.default_rng(3)
    npts, n_emb = 6000, 32_768
    pos = np.sort(rng.choice(n_emb, size=npts, replace=False))
    rows = rng.integers(0, npts, size=npts * 12)
    cols = np.clip(rows + rng.integers(-40, 41, size=rows.size), 0, npts - 1)
    M = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(npts, npts))
    A = tdia.build_embedded_dia(M, pos, pos, n_emb, dtype, cuda, tail_min=60)
    C = tdia.build_embedded_dia(M, pos, pos, n_emb, dtype, "cpu", tail_min=60)
    assert isinstance(A, tdia.DIAWithTail) and len(A.dia.offsets) > 64
    assert launch_plan(n_emb, A.dia.offsets) == (False, False)
    x = torch.from_numpy(rng.standard_normal(n_emb)).to(xdtype)
    counts = (dia_spmv_cuda.launches, coo_tail_cuda.launches,
              dia_spmv_cuda.tail_launches)
    y = spmv(A, x.to(cuda))
    assert (dia_spmv_cuda.launches, coo_tail_cuda.launches,
            dia_spmv_cuda.tail_launches) == (counts[0] + 1, counts[1],
                                             counts[2] + 1)
    assert _rel(y.cpu(), spmv(C, x)) <= tol
    xc = x.to(cuda)
    for form in FORMS:
        ops = _operands(form, n_emb, xdtype, cuda, seed=7)
        got = tdia._spmv_form(A, xc, form, **ops)
        want = epilogue(form, tdia.spmv_tail_after(A, xc), xc, **ops)
        torch.cuda.synchronize()
        assert (torch.equal(got, want) if dtype == "float64"
                else _rel(got, want) <= tol), form
        assert torch.equal(tdia._spmv_form(A, xc, form, **ops), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n,noff,lanes", [
    (13_824, 413, None), (13_824, 413, 2), (13_824, 35, None),
    (13_825, 120, 8), (110_592, 289, None), (3456, 28, 32), (1000, 9, 16)])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_k1_offset_lanes_match_plain_on_card(cuda, n, noff, lanes, form,
                                             dtype, xdtype, tol):
    """Many offsets on few rows: S lanes share a row's taps (the
    wrapper's pick with lanes=None, else forced), every form; the
    out-of-range taps are left nonzero in the data."""
    rng = np.random.default_rng(n + noff)
    offsets = tuple(int(o) for o in np.sort(rng.choice(
        np.arange(-n // 2, n // 2), size=noff, replace=False)))
    data = torch.from_numpy(rng.standard_normal((noff, n))).to(
        cuda, getattr(torch, dtype))
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda, xdtype)
    if lanes is None:
        assert offset_lanes(n, noff) > 1
    ops = _operands(form, n, xdtype, cuda, seed=n)
    before = dia_spmv_cuda.launches
    y = dia_spmv_cuda(data, offsets, x, form, lanes=lanes, **ops)
    assert dia_spmv_cuda.launches == before + 1
    ref = dia_spmv_reference(data, offsets, x, form, **ops)
    torch.cuda.synchronize()
    # sums of hundreds of O(1) products that cancel: scale by their size
    scale = float(ref.abs().max()) + noff ** 0.5
    assert float((y - ref).abs().max()) / scale <= tol
    assert torch.equal(dia_spmv_cuda(data, offsets, x, form, lanes=lanes,
                                     **ops), y)  # a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("noff,lanes", [(7, 1), (40, 1), (40, 4), (40, 16)])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_k1_tail_in_each_kernel_is_the_composition_on_card(
        cuda, noff, lanes, form, dtype, xdtype, tol):
    """K1 with a tail, on the row kernel by value (7 offsets), on the row
    kernel through the device array and on the offset-lane kernel, every
    form: the composition it replaces (K1, coo_tail, the torch
    epilogue), bitwise in f64; its plain version to tol; the same bits
    on a second run; the tail from another vector.  A tailed launch on
    the row kernel takes the one-row-a-thread instances, which round the
    sum otherwise than the 16-byte ones, so x is one element off a
    16-byte boundary here: the composition's K1 takes them too."""
    rng = np.random.default_rng(noff + lanes)
    A = csr_to_dia(laplacian_7pt(20, 20, 16), dtype, cuda)
    n = A.num_rows
    data, offsets = A.data, A.offsets
    if noff > 8:  # the device array; out-of-range taps left nonzero
        offsets = tuple(int(o) for o in np.sort(rng.choice(
            np.arange(-500, 500), noff, replace=False)))
        data = torch.from_numpy(rng.standard_normal((noff, n))).to(
            cuda, getattr(torch, dtype))
    T = tdia._build_tail(*_tail_entries(lanes, n, 2 * n, 9000), dtype, cuda,
                         n_rows=n)
    x = torch.empty(n + 1, dtype=xdtype, device=cuda)[1:]
    x.copy_(torch.from_numpy(rng.standard_normal(n)))
    assert not vector_path(n, data, x)
    tx = torch.from_numpy(rng.standard_normal(2 * n)).to(cuda, xdtype)
    ops = _operands(form, n, xdtype, cuda, seed=lanes)
    before = (dia_spmv_cuda.launches, dia_spmv_cuda.tail_launches)
    y = dia_spmv_cuda(data, offsets, x, form, lanes=lanes, tail=T.k1(tx), **ops)
    assert (dia_spmv_cuda.launches, dia_spmv_cuda.tail_launches) == (
        before[0] + 1, before[1] + 1)
    ax = dia_spmv_cuda(data, offsets, x, lanes=lanes)
    want = epilogue(form, tdia.tail_apply(T, tx, ax), x, **ops)
    ref = dia_spmv_reference(data, offsets, x, form, tail=T.k1(tx), **ops)
    torch.cuda.synchronize()
    if dtype == "float64":
        assert torch.equal(y, want)
    scale = float(ref.abs().max()) + len(offsets) ** 0.5
    assert float((y - want).abs().max()) / scale <= tol
    assert float((y - ref).abs().max()) / scale <= tol
    assert torch.equal(dia_spmv_cuda(data, offsets, x, form, lanes=lanes,
                                     tail=T.k1(tx), **ops), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,xdtype,tol", DTYPES)
def test_k1_with_no_diagonals_is_its_tail_on_card(cuda, dtype, xdtype, tol):
    n = 3456
    T = tdia._build_tail(*_tail_entries(3, n, n, 5000), dtype, cuda, n_rows=n)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n)).to(
        cuda, xdtype)
    data = torch.zeros(0, n, dtype=T.vals.dtype, device=cuda)
    y = dia_spmv_cuda(data, (), x, tail=T.k1())
    want = tdia.tail_apply(T, x, torch.zeros_like(x))
    torch.cuda.synchronize()
    assert torch.equal(y, want) if dtype == "float64" else _rel(y, want) <= tol


@pytest.mark.cuda
def test_k1_refuses_a_bad_tail(cuda):
    A = csr_to_dia(laplacian_7pt(6, 6, 6), "float32", cuda)
    T = tdia._build_tail(*_tail_entries(1, 216, 216, 1000), "float32", cuda,
                         n_rows=216)
    x = torch.ones(216, device=cuda)
    ptr, cols, vals, _ = T.k1()
    with pytest.raises(ValueError, match="ptr"):
        dia_spmv_cuda(A.data, A.offsets, x, tail=(ptr[:-1], cols, vals, None))
    with pytest.raises(TypeError):
        dia_spmv_cuda(A.data, A.offsets, x, tail=(ptr, cols, vals.double(), None))
    with pytest.raises(ValueError, match="device"):
        dia_spmv_cuda(A.data, A.offsets, x, tail=(ptr, cols.cpu(), vals, None))
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv_cuda(A.data, A.offsets, x, tail=(
            ptr, cols, vals, torch.ones(432, device=cuda)[::2]))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n_cells", [(1529, 3456), (1731, 3456), (7000, 9000),
                                       (5, 40)])
@pytest.mark.parametrize("dtype,xdtype,tol", [
    ("float64", torch.float64, 1e-12), ("float32", torch.float32, 1e-4),
    ("bfloat16", torch.float32, 1e-4)])
def test_cell_dense_matches_plain_on_card(cuda, k, n_cells, dtype, xdtype, tol):
    """One launch against the gather, the product and the scatter: to
    tol, zeros off the cells, the same bits on a second run; 7,000
    columns need more than 48 KB of shared memory in f64."""
    rng = np.random.default_rng(k)
    cells = np.sort(rng.choice(n_cells, size=k, replace=False))
    D = tdia.DenseMatrix(torch.from_numpy(rng.standard_normal((k, k))).to(
        cuda, getattr(torch, dtype)), k, k)
    A = tdia.on_cells(D, cells, n_cells, cuda)
    x = torch.from_numpy(rng.standard_normal(n_cells)).to(cuda, xdtype)
    before = (cell_dense_cuda.launches, flat_take_cuda.launches)
    y = spmv(A, x)
    assert (cell_dense_cuda.launches, flat_take_cuda.launches) == (
        before[0] + 1, before[1])
    assert tdia.kernel_launches(A) == {"cell_dense": 1}
    ref = cell_dense_reference(D.data, A.inner.pos, A.row_of_cell, x)
    torch.cuda.synchronize()
    assert _rel(y, ref) <= tol
    off = torch.ones(n_cells, dtype=torch.bool, device=cuda)
    off[A.pos] = False
    assert not bool(y[off].any())
    assert torch.equal(cell_dense_cuda(D.data, A.inner.pos, A.row_of_cell, x), y)


@pytest.mark.cuda
def test_cell_dense_refuses_what_it_does_not_take(cuda):
    D = torch.ones(4, 4, device=cuda)
    pos = torch.arange(4, dtype=torch.int32, device=cuda)
    roc = torch.tensor([0, -1, 1, 2, 3], dtype=torch.int32, device=cuda)
    x = torch.ones(5, device=cuda)
    with pytest.raises(TypeError, match="unsupported"):
        cell_dense_cuda(D.double(), pos, roc, x)
    with pytest.raises(TypeError, match="int32"):
        cell_dense_cuda(D, pos.long(), roc, x)
    with pytest.raises(ValueError, match="device"):
        cell_dense_cuda(D, pos, roc.cpu(), x)
    with pytest.raises(ValueError, match="square"):
        cell_dense_cuda(D[:3], pos, roc, x)
    with pytest.raises(ValueError, match="shared"):  # 30,000 f64 values
        big = torch.ones(1, 1, device=cuda, dtype=torch.float64).expand(
            30_000, 30_000)
        cell_dense_cuda(big, torch.zeros(30_000, dtype=torch.int32, device=cuda),
                        roc, x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("interp,kw", [
    ("classical", dict(dtype="float64")),
    ("ext+i", dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02)),
])
def test_device_rap_on_card_is_the_cpu_pass(cuda, interp, kw):
    """The device RAP (ops/device_rap.py: level-1 A and the transposed
    level-0 R) at 20^3 on the card, bitwise the same pass on the CPU:
    gathers, IEEE products and sums in one order on both."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions

    opts = BoomerAMGOptions(coarsen_type="pmis", interp_type=interp,
                            P_max_elmts=4, relax_down=18, relax_up=18,
                            lattice_shape=(20, 20, 20), **kw)
    A = laplacian_7pt(20, 20, 20)
    card = BoomerAMG(A, opts, device=cuda)
    host = BoomerAMG(A, opts, device="cpu")
    for lvl, name in ((1, "A"), (0, "R")):
        M, H = getattr(card.levels[lvl], name), getattr(host.levels[lvl], name)
        assert isinstance(M, tdia.DIAMatrix) and M.offsets == H.offsets
        assert torch.equal(M.data.cpu(), H.data), f"L{lvl} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(dtype="float64"),
    dict(dtype="float32", mat_dtype="bfloat16", nongalerkin_tol=0.02),
])
def test_device_setup_on_card_is_the_cpu_chain(cuda, kw):
    """The device setup chain (device_setup, lattice_coeffs) at 20^3 on
    the card: the CF marker, level-0 P / R and level-1 A bitwise the
    same chain on the CPU (elementwise IEEE operations in one order on
    both), the compact level-1 A the host continues from too."""
    from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions

    opts = BoomerAMGOptions(coarsen_type="pmis", interp_type="classical",
                            P_max_elmts=4, relax_down=18, relax_up=18,
                            lattice_shape=(20, 20, 20), device_setup=True,
                            lattice_coeffs=(1.0, 1.0, 1.0), **kw)
    A = laplacian_7pt(20, 20, 20)
    card = BoomerAMG(A, opts, device=cuda)
    host = BoomerAMG(A, opts, device="cpu")
    assert card._fast is not None and host._fast is not None
    assert np.array_equal(card._cf[0], host._cf[0])
    assert torch.equal(card._fast["P"].data.cpu(), host._fast["P"].data)
    for lvl, name in ((0, "A"), (0, "P"), (0, "R"), (1, "A")):
        M, H = getattr(card.levels[lvl], name), getattr(host.levels[lvl], name)
        assert isinstance(M, tdia.DIAMatrix) and M.offsets == H.offsets
        assert torch.equal(M.data.cpu(), H.data), f"L{lvl} {name}"
    assert abs(card._host_A[1] - host._host_A[1]).max() == 0.0


def _gs_matrix(kind):
    """(CSRMatrix, expect a hazard wavefront): a 3D Laplacian, or a
    random nonsymmetric pattern whose wavefronts hold rows that read
    same-wavefront neighbours."""
    if kind == "laplacian":
        return laplacian_7pt(14, 12, 10), False
    rng = np.random.default_rng(11)
    n = 3000
    B = sp.random(n, n, 4.0 / n, random_state=rng, format="csr")
    M = (B + sp.diags(8.0 + rng.random(n))).tocsr()
    M.sort_indices()
    return CSRMatrix.from_scipy(M), True


@pytest.fixture
def no_gs_fault(cuda):
    """The device's GS fault word is 0 before the test and after it."""
    from hypre_tpu_torch.ops.gs_kernel import clear_fault, read_fault

    clear_fault(cuda)
    yield
    torch.cuda.synchronize()
    assert read_fault(cuda) == 0, "a sync-free GS wait gave up"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["laplacian", "nonsymmetric"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("form,coop,lanes", [
    ("wavefront", False, None), ("wavefront", True, None),
    ("wavefront", False, 1), ("wavefront", True, 32),
    ("syncfree", None, None), ("syncfree", None, 1), ("syncfree", None, 32)])
@pytest.mark.parametrize("vdt,tol", [(torch.float64, 1e-12),
                                     (torch.float32, 1e-6)])
def test_gs_sweep_matches_plain_on_card(cuda, no_gs_fault, kind, forward,
                                        omega, form, coop, lanes, vdt, tol):
    """One launch a sweep, in the sync-free form and the wavefront form's
    one-block and cooperative-grid variants, against the plain version
    over the JAX layout's slabs on the same inputs: relative to max |u|
    within tol; the same bits twice."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda, gs_sweep_reference
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    A, hazard = _gs_matrix(kind)
    sched = build_gs_schedule(A, forward, device=cuda)
    assert sched.any_hazard == hazard
    rng = np.random.default_rng(5)
    u, f, v = (torch.from_numpy(rng.standard_normal(A.shape[0])).to(cuda, vdt)
               for _ in range(3))
    before = gs_sweep_cuda.launches
    got = gs_sweep_cuda(sched, u, f, 0.9, omega, v, form=form, coop=coop,
                        lanes=lanes)
    assert gs_sweep_cuda.launches == before + 1
    want = gs_sweep_reference(sched.slabs(cuda), sched.n, u, f, 0.9, omega, v)
    torch.cuda.synchronize()
    assert _rel(got, want) <= tol
    assert torch.equal(gs_sweep_cuda(sched, u, f, 0.9, omega, v, form=form,
                                     coop=coop, lanes=lanes), got)


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
def test_gs_sweep_masked_halves_on_card(cuda, no_gs_fault, forward):
    """The C and F halves of a CF-ordered sweep (relax_order 1): only the
    half's rows change, each against the plain version, the sync-free
    form bitwise the wavefront form."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda, gs_sweep_reference
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    A = laplacian_7pt(12, 12, 12)
    rng = np.random.default_rng(8)
    cmask = rng.random(A.shape[0]) < 0.3
    u, f = (torch.from_numpy(rng.standard_normal(A.shape[0])).to(cuda)
            for _ in range(2))
    for mask in (cmask, ~cmask):
        sched = build_gs_schedule(A, forward, mask=mask, device=cuda)
        got = gs_sweep_cuda(sched, u, f, 1.0)
        want = gs_sweep_reference(sched.slabs(cuda), sched.n, u, f, 1.0)
        torch.cuda.synchronize()
        assert _rel(got, want) <= 1e-12
        still = torch.from_numpy(~mask).to(cuda)
        assert torch.equal(got[still], u[still])
        assert torch.equal(got, gs_sweep_cuda(sched, u, f, 1.0,
                                              form="wavefront"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["laplacian", "nonsymmetric"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("vdt", [torch.float64, torch.float32])
def test_gs_syncfree_is_the_wavefront_form_bitwise(cuda, no_gs_fault, kind,
                                                   forward, omega, vdt):
    """At each lane count S from 1 to 32 (the sum's lane order depends on
    S, so both forms take the same S): the sync-free form's bits are the
    wavefront form's, in its one-block and its grid variant, plain and
    omega forms, f64 and f32, on the hazard matrix too."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    A, _ = _gs_matrix(kind)
    sched = build_gs_schedule(A, forward, device=cuda)
    rng = np.random.default_rng(12)
    u, f, v = (torch.from_numpy(rng.standard_normal(A.shape[0])).to(cuda, vdt)
               for _ in range(3))
    for s in (1, 2, 4, 8, 16, 32):
        got = gs_sweep_cuda(sched, u, f, 0.9, omega, v, form="syncfree",
                            lanes=s)
        for coop in (False, True):
            want = gs_sweep_cuda(sched, u, f, 0.9, omega, v, form="wavefront",
                                 coop=coop, lanes=s)
            assert torch.equal(got, want), (s, coop)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [0, 3])
def test_gs_syncfree_repeats_its_bits(cuda, no_gs_fault, blocks):
    """100 sweeps of one schedule back to back (the level's epoch advances
    on the device each time): the same bits every time, also with the
    grid capped to 3 blocks (many passes a warp); the level's epoch
    counts the sweeps."""
    from hypre_tpu_torch.ops.gs_kernel import free_lanes, gs_sweep_cuda
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    A = laplacian_7pt(30, 28, 26)
    sched = build_gs_schedule(A, True, device=cuda)
    rng = np.random.default_rng(21)
    u, f = (torch.from_numpy(rng.standard_normal(A.shape[0])).to(cuda)
            for _ in range(2))
    first = gs_sweep_cuda(sched, u, f, 0.9, form="wavefront",
                          lanes=free_lanes(sched.max_row))
    outs = [gs_sweep_cuda(sched, u, f, 0.9, blocks=blocks) for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, first) for o in outs)
    assert int(sched.mat.ctl[0]) == 100 and int(sched.mat.ctl[1]) == 0
    # every row's words carry the last sweep's epoch and its value
    assert int((sched.mat.done >> 32).min()) == 100
    lo, hi = (sched.mat.done & 0xFFFFFFFF).unbind(1)
    assert torch.equal((hi << 32 | lo).view(torch.float64), first)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["published", "flag"])
def test_gs_step_probe_on_card(cuda, mode):
    """t_step, a cross-SM step (the sync-free form's, and the flag design
    it replaced): two SMs, every value right, a time between 50 ns and
    20 us."""
    from hypre_tpu_torch.ops.gs_kernel import step_probe

    r = step_probe(cuda, 2000, mode)
    assert r["sms"][0] != r["sms"][1]
    assert 50 <= r["ns"] <= 20000


@pytest.mark.cuda
def test_gs_sweep_refuses_what_it_does_not_take(cuda):
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda
    from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule

    A = laplacian_7pt(6, 6, 6)
    sched = build_gs_schedule(A, True, device=cuda)
    u = torch.ones(216, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        gs_sweep_cuda(sched, u.half(), u.half())
    with pytest.raises(ValueError, match="contiguous"):
        gs_sweep_cuda(sched, u, torch.ones(432, device=cuda,
                                           dtype=torch.float64)[::2])
    with pytest.raises(ValueError, match="CUDA"):
        gs_sweep_cuda(sched, u.cpu(), u.cpu())
    with pytest.raises(ValueError, match="lanes"):
        gs_sweep_cuda(sched, u, u, lanes=3)
    with pytest.raises(ValueError, match="form"):
        gs_sweep_cuda(sched, u, u, form="barrier")
    with pytest.raises(ValueError, match="coop"):
        gs_sweep_cuda(sched, u, u, form="syncfree", coop=True)
    cpu_sched = build_gs_schedule(A, True, device="cpu")
    with pytest.raises(ValueError, match="device"):
        gs_sweep_cuda(cpu_sched, u, u)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(relax_down=13, relax_up=14),
    dict(relax_down=6, relax_up=6, omega=0.8, relax_weight=0.9),
    dict(relax_down=13, relax_up=14, relax_order=1),
    dict(relax_down=16, relax_up=16),
    dict(relax_down=17, relax_up=17),
    dict(relax_down=15, relax_up=15),
])
def test_smoothers_solve_the_same_on_card_and_cpu(cuda, kw):
    """PCG over the same 12^3 hierarchy built on the card and on the
    CPU: the same iterations, x within 1e-10; every GS sweep one
    launch, as `cycle_launches` says."""
    from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda
    from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    opts = BoomerAMGOptions(coarsen_type="pmis", interp_type="classical",
                            P_max_elmts=4, embed_level1=False, **kw)
    A = laplacian_7pt(12, 12, 12)
    out = []
    for dev in (cuda, torch.device("cpu")):
        amg = BoomerAMG(A, opts, device=dev)
        b = torch.ones(1728, dtype=torch.float64, device=dev)
        before = gs_sweep_cuda.launches
        res = pcg(lambda x: spmv(amg.levels[0].A, x), b, M=amg.precond,
                  opts=PCGOptions(tol=1e-8, max_iter=100, two_norm=True))
        out.append((res, gs_sweep_cuda.launches - before,
                    amg.cycle_launches()["gs_sweep"]))
    (rc, nc, per), (rh, nh, _) = out
    assert rc.converged and rc.num_iterations == rh.num_iterations
    assert nc == per * (rc.num_iterations + 1) and nh == 0
    assert _rel(rc.x.cpu(), rh.x) <= 1e-10
