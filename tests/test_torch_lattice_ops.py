"""The lattice forms of the port's ops/dia.py against the JAX package's
(hypre_tpu/ops/dia.py), on the CPU, from numpy-seeded inputs.

Tolerances: host planning (relocate_to_cells, offsets, tail rows /
segments / columns) equal as integers; DIA and tail values bitwise
after the cast to the storage dtype; spmv over each operator type
<= 1e-12 relative in f64 and <= 1e-5 in f32 and bf16/f32 against
hypre_tpu.ops.dia.spmv (the parity operators sum in another order than
the JAX package's union-of-offsets pass, so f64 is not bitwise).  The
fused forms over the lattice operators equal the plain matvec followed
by ops/forms.py::epilogue bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.ops import dia as jdia
from hypre_tpu_torch.ops import dia as tdia
from hypre_tpu_torch.ops.cell_dense_kernel import cell_dense_cuda
from hypre_tpu_torch.ops.csr import to_device
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, offset_lanes
from hypre_tpu_torch.ops.forms import epilogue
from hypre_tpu_torch.ops.gather_kernel import flat_take_cuda
from hypre_tpu_torch.ops.tail_kernel import coo_tail_cuda
from torch_threads import one_thread  # noqa: F401

# (matrix dtype, vector dtype, jax vector dtype, tolerance)
DTYPES = {
    "f64": ("float64", torch.float64, jnp.float64, 1e-12),
    "f32": ("float32", torch.float32, jnp.float32, 1e-5),
    "bf16": ("bfloat16", torch.float32, jnp.float32, 1e-5),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy; bf16 as its 16-bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def _random_embedded(rng, npts, n_emb, density=12):
    """Sparse operator on npts points embedded at distinct positions."""
    pos = np.sort(rng.choice(n_emb, size=npts, replace=False))
    rows = rng.integers(0, npts, size=npts * density)
    cols = np.clip(rows + rng.integers(-40, 41, size=rows.size), 0, npts - 1)
    vals = rng.standard_normal(rows.size)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(npts, npts))
    return M, pos


def _same_dia(T, J):
    """Port DIA vs JAX DIA: offsets equal, data bitwise (the JAX data
    may carry width padding past num_rows)."""
    assert T.offsets == tuple(int(o) for o in J.offsets)
    assert (T.num_rows, T.num_cols) == (J.num_rows, J.num_cols)
    jd = _jbits(J.data)[:, :J.num_rows]
    assert T.data.dtype == {"float64": torch.float64, "float32": torch.float32,
                            "bfloat16": torch.bfloat16}[np.asarray(J.data).dtype.name]
    assert np.array_equal(_bits(T.data), jd)


def _same_tail(T, J):
    assert np.array_equal(T.rows_u.numpy(), np.asarray(J.rows_u))
    assert np.array_equal(T.seg.numpy(), np.asarray(J.seg))
    assert np.array_equal(T.cols.numpy(), np.asarray(J.cols))
    assert np.array_equal(_bits(T.vals), _jbits(J.vals))
    ptr = T.seg_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == T.nnz and (np.diff(ptr) > 0).all()


def test_parity_split_merge_roundtrip():
    shape, factors = (6, 4, 8), (2, 2, 2)
    x = np.arange(np.prod(shape), dtype=np.float64)
    parts = tdia.parity_split(torch.from_numpy(x), shape, factors)
    ref = jdia.parity_split(jnp.asarray(x), shape, factors)
    assert parts.shape == (8, np.prod(shape) // 8) and parts.is_contiguous()
    assert np.array_equal(parts.numpy(), np.stack([np.asarray(p) for p in ref]))
    y = tdia.parity_merge(parts, shape, factors)
    assert np.array_equal(y.numpy(), x)


@pytest.mark.parametrize("factors", [(1, 2, 2), (2, 2, 2), (1, 1, 2), (1, 4, 2)])
def test_parity_split_matches_jax(factors):
    shape = (8, 12, 16)
    x = np.random.default_rng(1).standard_normal(np.prod(shape))
    parts = tdia.parity_split(torch.from_numpy(x), shape, factors)
    ref = np.stack([np.asarray(p) for p in
                    jdia.parity_split(jnp.asarray(x), shape, factors)])
    assert np.array_equal(parts.numpy(), ref)
    assert np.array_equal(tdia.parity_merge(parts, shape, factors).numpy(), x)
    assert np.array_equal(
        np.asarray(jdia.parity_merge(list(jnp.asarray(ref)), shape, factors)), x)


@pytest.mark.parametrize("factors,npts", [((2, 2, 2), 400), ((1, 2, 2), 900),
                                          ((1, 2, 2), 921), ((2, 2, 2), 460)])
def test_relocate_to_cells_is_injective_and_matches_jax(factors, npts):
    """921 and 460 points are a 0.9 load: cell rows overflow and the
    carry stage runs."""
    rng = np.random.default_rng(0)
    shape = (16, 16, 16)
    pos = np.sort(rng.choice(16**3, size=npts, replace=False))
    cells = tdia.relocate_to_cells(pos, shape, factors)
    ref = jdia.relocate_to_cells(pos, shape, factors)
    assert cells is not None and cells.dtype == np.int64
    assert len(np.unique(cells)) == len(pos)  # distinct cells
    assert np.array_equal(cells, ref)
    assert tdia.relocate_to_cells(pos, shape, (2, 4, 4)) is None  # overfull


def test_relocate_to_cells_stays_near():
    rng = np.random.default_rng(0)
    pos = np.sort(rng.choice(16**3, size=400, replace=False))
    cells = tdia.relocate_to_cells(pos, (16, 16, 16), (2, 2, 2))
    ix, iy, iz = pos % 16, (pos // 16) % 16, pos // 256
    cx, cy, cz = cells % 8, (cells // 8) % 8, cells // 64
    d = np.maximum.reduce([abs(ix // 2 - cx), abs(iy // 2 - cy), abs(iz // 2 - cz)])
    assert np.quantile(d, 0.9) <= 2
    assert d.max() <= 8


def test_tail_min_count_matches_jax():
    for ncells, itemsize in ((110592, 8), (110592, 2), (13824, 4), (100, 8)):
        assert tdia.tail_min_count(ncells, itemsize) == jdia.tail_min_count(
            ncells, itemsize)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("tail_min", [0, 30])
def test_embedded_dia_matches_jax(dt, tail_min):
    mdt, vdt, jvdt, tol = DTYPES[dt]
    rng = np.random.default_rng(3)
    M, pos = _random_embedded(rng, 700, 4096)
    x = rng.standard_normal(4096)
    T = tdia.build_embedded_dia(M, pos, pos, 4096, mdt, "cpu", tail_min=tail_min)
    J = jdia.build_embedded_dia(M, pos, pos, 4096, np.dtype(
        jnp.bfloat16 if mdt == "bfloat16" else mdt), tail_min=tail_min)
    if tail_min:
        assert isinstance(T, tdia.DIAWithTail) and T.tail.nnz > 0
        _same_dia(T.dia, J.dia)
        _same_tail(T.tail, J.tail)
    else:
        assert isinstance(T, tdia.DIAMatrix)
        _same_dia(T, J)
    y = tdia.spmv(T, torch.from_numpy(x).to(vdt)).numpy()
    ref = np.asarray(jdia.spmv(J, jnp.asarray(x, jvdt)))
    assert _rel(y, ref) <= tol


def test_embedded_tail_matvec_exact():
    rng = np.random.default_rng(3)
    M, pos = _random_embedded(rng, 700, 4096)
    x = torch.from_numpy(rng.standard_normal(4096))
    plain = tdia.build_embedded_dia(M, pos, pos, 4096, "float64", "cpu")
    hybrid = tdia.build_embedded_dia(M, pos, pos, 4096, "float64", "cpu",
                                     tail_min=30)
    assert isinstance(hybrid, tdia.DIAWithTail)
    assert len(hybrid.dia.offsets) < len(plain.offsets)
    assert hybrid.tail.nnz > 0
    y0, y1 = tdia.spmv(plain, x).numpy(), tdia.spmv(hybrid, x).numpy()
    np.testing.assert_allclose(y1, y0, rtol=1e-12, atol=1e-12)
    # against the operator itself
    E = sp.csr_matrix((M.tocoo().data, (pos[M.tocoo().row], pos[M.tocoo().col])),
                      shape=(4096, 4096))
    np.testing.assert_allclose(y1, E @ x.numpy(), rtol=1e-12, atol=1e-12)


def test_embedded_offset_counts_match_jax():
    rng = np.random.default_rng(4)
    M, pos = _random_embedded(rng, 700, 4096)
    assert np.array_equal(tdia.embedded_offsets(M, pos, pos),
                          jdia.embedded_offsets(M, pos, pos))
    for tail_min in (0, 30, 10**6):
        assert tdia.embedded_offset_count(M, pos, pos, tail_min) == \
            jdia.embedded_offset_count(M, pos, pos, tail_min)
    # int64 indices take the other native entry point
    M64 = M.tocoo()
    M64 = sp.coo_matrix((M64.data, (M64.row.astype(np.int64),
                                    M64.col.astype(np.int64))), shape=M.shape)
    assert np.array_equal(tdia._embedded_counts(M64, pos, pos)[1],
                          tdia._embedded_counts(M, pos, pos)[1])


def _jax_spmv(J, x):
    """The JAX package's spmv under one jit: its parity matvec runs one
    shifted multiply per offset of the union, each a program of its own
    when run eagerly."""
    return np.asarray(jax.jit(lambda v: jdia.spmv(J, v))(x))


def _parity_problem(seed=5):
    """An interpolation-like M (fine lattice rows, point columns near
    the row), so the parity diagonals are some dozens, not thousands."""
    rng = np.random.default_rng(seed)
    shape, factors = (16, 16, 16), (1, 2, 2)
    npts = 500
    pts_pos = np.sort(rng.choice(16**3, size=npts, replace=False))
    ccol = tdia.relocate_to_cells(pts_pos, shape, factors)
    rows = rng.integers(0, 16**3, size=3000)
    near = np.clip(np.searchsorted(pts_pos, rows), 0, npts - 1)
    cols = np.clip(near + rng.integers(-1, 2, size=3000), 0, npts - 1)
    vals = rng.standard_normal(3000)
    M = sp.csr_matrix((vals, (rows, cols)), shape=(16**3, npts))
    Mf = sp.csr_matrix((M.tocoo().data, (M.tocoo().row, M.tocoo().col)),
                       shape=(16**3, npts))
    xc = np.zeros(16 * 8 * 8)
    xc[ccol] = rng.standard_normal(npts)
    xf = rng.standard_normal(16**3)
    return shape, factors, ccol, Mf, xc, xf


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("tail_min", [0, 4])
def test_parity_ops_match_jax(dt, tail_min):
    mdt, vdt, jvdt, tol = DTYPES[dt]
    jmdt = np.dtype(jnp.bfloat16 if mdt == "bfloat16" else mdt)
    shape, factors, ccol, Mf, xc, xf = _parity_problem()
    P = tdia.build_parity_interp(Mf, ccol, shape, factors, mdt, "cpu",
                                 tail_min=tail_min)
    R = tdia.build_parity_restrict(Mf.T.tocsr(), ccol, shape, factors, mdt,
                                   "cpu", tail_min=tail_min)
    JP = jdia.build_parity_interp(Mf, ccol, shape, factors, jmdt,
                                  tail_min=tail_min)
    JR = jdia.build_parity_restrict(Mf.T.tocsr(), ccol, shape, factors, jmdt,
                                    tail_min=tail_min)
    for T, J in ((P, JP), (R, JR)):
        assert len(T.mats) == len(J.mats) == 4
        for a, b in zip(T.mats, J.mats):
            _same_dia(a, b)
        assert (T.tail is None) == (J.tail is None) == (tail_min == 0)
        if tail_min:
            _same_tail(T.tail, J.tail)
        assert tdia.parity_offset_count(T) == jdia.parity_offset_count(J)
    assert (P.num_rows, P.num_cols) == (16**3, 16 * 8 * 8)
    assert (R.num_rows, R.num_cols) == (16 * 8 * 8, 16**3)
    y = tdia.spmv(P, torch.from_numpy(xc).to(vdt)).numpy()
    assert _rel(y, _jax_spmv(JP, jnp.asarray(xc, jvdt))) <= tol
    z = tdia.spmv(R, torch.from_numpy(xf).to(vdt)).numpy()
    assert _rel(z, _jax_spmv(JR, jnp.asarray(xf, jvdt))) <= tol


def test_parity_tail_matvec_exact():
    shape, factors, ccol, Mf, xc, xf = _parity_problem()
    P0 = tdia.build_parity_interp(Mf, ccol, shape, factors, "float64", "cpu")
    P1 = tdia.build_parity_interp(Mf, ccol, shape, factors, "float64", "cpu",
                                  tail_min=4)
    assert P1.tail is not None
    y0 = tdia.spmv(P0, torch.from_numpy(xc)).numpy()
    y1 = tdia.spmv(P1, torch.from_numpy(xc)).numpy()
    np.testing.assert_allclose(y1, y0, rtol=1e-12, atol=1e-12)
    R0 = tdia.build_parity_restrict(Mf.T.tocsr(), ccol, shape, factors,
                                    "float64", "cpu")
    R1 = tdia.build_parity_restrict(Mf.T.tocsr(), ccol, shape, factors,
                                    "float64", "cpu", tail_min=4)
    assert R1.tail is not None
    z0 = tdia.spmv(R0, torch.from_numpy(xf)).numpy()
    z1 = tdia.spmv(R1, torch.from_numpy(xf)).numpy()
    np.testing.assert_allclose(z1, z0, rtol=1e-12, atol=1e-12)
    # R is P^T: <R xf, xc> == <xf, P xc>
    assert abs(z1 @ xc - xf @ y1) <= 1e-10 * abs(xf @ y1)


@pytest.mark.parametrize("restrict", [False, True])
@pytest.mark.parametrize("tail_min", [0, 4])
def test_parity_offset_count_plan_matches_build_and_jax(restrict, tail_min):
    shape, factors, ccol, Mf, _, _ = _parity_problem()
    M = Mf.T.tocsr() if restrict else Mf
    plan = tdia.parity_offset_count_plan(M, ccol, shape, factors, restrict,
                                         tail_min=tail_min)
    assert plan == jdia.parity_offset_count_plan(M, ccol, shape, factors,
                                                 restrict, tail_min=tail_min)
    build = tdia.build_parity_restrict if restrict else tdia.build_parity_interp
    op = build(M, ccol, shape, factors, "float64", "cpu", tail_min=tail_min)
    assert plan == tdia.parity_offset_count(op)


def test_dia_from_coo_matches_jax():
    rng = np.random.default_rng(9)
    n = 600
    flat = rng.choice(n * n, size=4000, replace=False)
    rows, cols = flat // n, flat % n
    keep = np.abs(cols - rows) < 50
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(len(rows))
    for mdt in ("float64", "bfloat16"):
        T = tdia.dia_from_coo(rows, cols, vals, n, mdt, "cpu")
        J = jdia.dia_from_coo(rows, cols, vals, n, n, np.dtype(
            jnp.bfloat16 if mdt == "bfloat16" else mdt))
        _same_dia(T, J)
    empty = tdia.dia_from_coo(rows[:0], cols[:0], vals[:0], n, "float64", "cpu")
    assert empty.offsets == () and tuple(empty.data.shape) == (0, n)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_gather_scatter_ops_match_jax(dt):
    mdt, vdt, jvdt, tol = DTYPES[dt]
    rng = np.random.default_rng(12)
    n_out, k, m = 900, 300, 120
    pos = np.sort(rng.choice(n_out, size=k, replace=False))
    D = rng.standard_normal((k, k))
    Pm = rng.standard_normal((k, m))
    dense = tdia.DenseMatrix(to_device(D, getattr(torch, mdt), "cpu"), k, k)
    jdense = jdia.DenseMatrix(jnp.asarray(D, jnp.bfloat16 if mdt == "bfloat16"
                                          else mdt), k, k)
    pos32 = torch.from_numpy(pos.astype(np.int32))
    pos64 = torch.from_numpy(pos)
    # dense core behind gather/scatter (a relocated small level, and the
    # collapsed coarse operator on a relocated level)
    T = tdia.ScatterOp(tdia.GatherOp(dense, pos32), pos64, n_out)
    J = jdia.ScatterOp(jdia.GatherOp(jdense, jnp.asarray(pos, jnp.int32)),
                       jnp.asarray(pos, jnp.int32), n_out)
    x = rng.standard_normal(n_out)
    y = tdia.spmv(T, torch.from_numpy(x).to(vdt))
    assert y.shape == (n_out,) and T.num_rows == n_out
    assert _rel(y.numpy(), np.asarray(jdia.spmv(J, jnp.asarray(x, jvdt)))) <= (
        tol if dt != "bf16" else 1e-4)  # k-term dot products in f32
    off = np.ones(n_out, bool)
    off[pos] = False
    assert not y.numpy()[off].any()
    # compact P / R below the last relocated level
    Pd = tdia.DenseMatrix(to_device(Pm, getattr(torch, mdt), "cpu"), k, m)
    Rd = tdia.DenseMatrix(to_device(Pm.T.copy(), getattr(torch, mdt), "cpu"), m, k)
    xm = torch.from_numpy(rng.standard_normal(m)).to(vdt)
    yP = tdia.spmv(tdia.ScatterOp(Pd, pos64, n_out), xm)
    assert np.array_equal(yP.numpy()[pos], tdia.spmv(Pd, xm).numpy())
    xr = torch.from_numpy(x).to(vdt)
    yR = tdia.spmv(tdia.GatherOp(Rd, pos32), xr)
    assert np.array_equal(yR.numpy(), tdia.spmv(Rd, xr[pos64]).numpy())


def _lattice_operators():
    """One operator of each type without a fused kernel form."""
    rng = np.random.default_rng(3)
    M, pos = _random_embedded(rng, 700, 4096)
    shape, factors, ccol, Mf, _, _ = _parity_problem()
    hybrid = tdia.build_embedded_dia(M, pos, pos, 4096, "float64", "cpu",
                                     tail_min=30)
    P = tdia.build_parity_interp(Mf, ccol, shape, factors, "float64", "cpu",
                                 tail_min=4)
    R = tdia.build_parity_restrict(Mf.T.tocsr(), ccol, shape, factors,
                                   "float64", "cpu", tail_min=4)
    D = tdia.DenseMatrix(torch.from_numpy(rng.standard_normal((700, 700))),
                         700, 700)
    p64 = torch.from_numpy(pos)
    p32 = p64.to(torch.int32)
    return {
        "dia_with_tail": hybrid,
        "parity_interp": P,
        "parity_restrict": R,
        "gather": tdia.GatherOp(D, p32),
        "scatter": tdia.ScatterOp(D, p64, 4096),
        "scatter_gather": tdia.ScatterOp(tdia.GatherOp(D, p32), p64, 4096),
    }


# operator kind -> columns; jacobi is for the square ones
_KIND_COLS = {"dia_with_tail": 4096, "parity_interp": 1024,
              "parity_restrict": 4096, "gather": 4096, "scatter": 700,
              "scatter_gather": 4096}
_SQUARE = ("dia_with_tail", "scatter_gather")


@pytest.mark.parametrize("kind,form", [
    (k, f) for k in _KIND_COLS for f in ("resid", "axpy", "jacobi")
    if f != "jacobi" or k in _SQUARE])
def test_forms_over_lattice_operators_are_matvec_then_epilogue(kind, form):
    A = _lattice_operators()[kind]
    n, m = A.num_rows, _KIND_COLS[kind]
    rng = np.random.default_rng(21)
    v = lambda k: torch.from_numpy(rng.standard_normal(k))  # noqa: E731
    x, f, u, d = v(m), v(n), v(n), v(n).abs()
    y = tdia.spmv(A, x)
    if form == "resid":
        got, want = tdia.spmv_resid(A, x, f), epilogue("resid", y, x, f=f)
    elif form == "axpy":
        got, want = tdia.spmv_axpy(A, x, u), epilogue("axpy", y, x, u=u)
    else:
        got = tdia.spmv_jacobi(A, d, x, f, 0.7)
        want = epilogue("jacobi", y, x, f=f, d=d, w=0.7)
    assert torch.equal(got, want)


def test_cpu_tensors_launch_no_kernel_and_counts_are_as_stated():
    """Every tail rides in K1 (no coo_tail launch): a DIAWithTail is one
    launch, each parity class of the interpolation carries its own share
    of the tail, the restriction's tail rides on its first launch; a
    dense operator on cells (`on_cells`) is one cell_dense launch."""
    dia_spmv_cuda.launches = flat_take_cuda.launches = coo_tail_cuda.launches = 0
    dia_spmv_cuda.tail_launches = cell_dense_cuda.launches = 0
    ops = _lattice_operators()
    rng = np.random.default_rng(5)
    ops["on_cells"] = tdia.on_cells(ops["gather"].inner, np.sort(
        rng.choice(4096, 700, replace=False)), 4096, "cpu")
    for kind, A in ops.items():
        tdia.spmv(A, torch.ones(_KIND_COLS.get(kind, 4096), dtype=torch.float64))
    assert (dia_spmv_cuda.launches, dia_spmv_cuda.tail_launches,
            flat_take_cuda.launches, coo_tail_cuda.launches,
            cell_dense_cuda.launches) == (0, 0, 0, 0, 0)
    assert tdia.kernel_launches(ops["dia_with_tail"]) == {
        "dia_spmv": 1, "dia_spmv_tail": 1}
    assert tdia.kernel_launches(ops["parity_interp"]) == {
        "dia_spmv": 4, "dia_spmv_tail": 4}
    assert tdia.kernel_launches(ops["parity_restrict"]) == {
        "dia_spmv": 4, "dia_spmv_tail": 1}
    assert tdia.kernel_launches(ops["scatter_gather"]) == {"flat_take": 1}
    assert tdia.kernel_launches(ops["scatter"]) == {}
    assert tdia.kernel_launches(ops["on_cells"]) == {"cell_dense": 1}


def test_parity_ops_skip_empty_classes():
    """A parity class without entries is an empty DIA: the interp writes
    zeros for it, the restrict skips it."""
    shape, factors = (4, 4, 4), (1, 2, 2)
    ncells = 16
    # interp entries only on fine rows of parity class 0
    rows = np.array([0, 1, 2, 8 * 4 + 0])  # iy, iz even
    cols = np.array([0, 1, 2, 3])
    M = sp.csr_matrix((np.ones(4), (rows, cols)), shape=(64, 4))
    ccol = np.array([0, 1, 2, 5])
    P = tdia.build_parity_interp(M, ccol, shape, factors, "float64", "cpu")
    assert [len(m.offsets) > 0 for m in P.mats] == [True, False, False, False]
    assert tdia.kernel_launches(P) == {"dia_spmv": 1}
    xc = np.arange(1.0, ncells + 1)
    E = sp.csr_matrix((np.ones(4), (rows, ccol[cols])), shape=(64, ncells))
    assert np.array_equal(tdia.spmv(P, torch.from_numpy(xc)).numpy(), E @ xc)
    R = tdia.build_parity_restrict(M.T.tocsr(), ccol, shape, factors,
                                   "float64", "cpu")
    xf = np.arange(1.0, 65)
    assert np.array_equal(tdia.spmv(R, torch.from_numpy(xf)).numpy(), E.T @ xf)


def test_k1_offset_lanes_rule():
    """One lane while the offsets go by value or the rows fill the card;
    else lanes double until rows x lanes fill it, two taps a lane at
    least, 32 lanes at most."""
    assert offset_lanes(884_736, 7) == offset_lanes(13_824, 8) == 1
    assert offset_lanes(884_736, 57) == 1  # the embedded level 1
    assert offset_lanes(110_592, 289) == 4
    assert offset_lanes(13_824, 413) == 32
    assert offset_lanes(13_824, 35) == 16
    assert offset_lanes(13_824, 9) == 4
    assert offset_lanes(100, 10_000) == 32
    for n, noff in ((13_824, 413), (110_592, 35), (3456, 28), (50, 9)):
        lanes = offset_lanes(n, noff)
        assert lanes == 1 or noff >= 2 * lanes
