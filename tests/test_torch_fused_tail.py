"""The lattice operators' tails riding in K1's launch, and the dense
operator on relocated cells as one `cell_dense` launch (ops/dia.py,
ops/dia_kernel.py, ops/cell_dense_kernel.py), on the CPU through the
kernels' plain versions, from numpy-seeded inputs on a 24^3 lattice.

Tolerances: the fused path (one K1 call carrying the tail, then the
form) equals the composition it replaces (`spmv_tail_after`: the DIA
parts, then `tail_apply`, then `epilogue`) bitwise, but for the parity
restriction, whose tail is now summed before the parity chain and not
after it: <= 1e-13 relative in f64, 1e-6 in f32.  Against the JAX
package's `spmv` on the same operator, plus the same epilogue: <= 1e-12
relative in f64, <= 1e-5 in f32 and bf16/f32 (its parity operators sum
over the union of offsets, another order).  The cell-dense plain version
against the JAX package's ScatterOp(GatherOp(dense)): 1e-12 in f64, 1e-5
in f32, 1e-4 in bf16/f32 (dot products of ~1,000 terms in f32), and
bitwise the port's unfused gather-product-scatter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.ops import dia as jdia
from hypre_tpu_torch.ops import dia as tdia
from hypre_tpu_torch.ops.cell_dense_kernel import (
    cell_dense_cuda, cell_dense_reference)
from hypre_tpu_torch.ops.csr import to_device
from hypre_tpu_torch.ops.dia_kernel import dia_spmv_cuda, dia_spmv_reference
from hypre_tpu_torch.ops.forms import epilogue
from hypre_tpu_torch.ops.tail_kernel import coo_tail_reference
from torch_threads import one_thread  # noqa: F401

SHAPE, FACTORS = (24, 24, 24), (2, 2, 2)
N = 24**3
NCELLS = N // 8
# (matrix dtype, vector dtype, jax matrix dtype, jax vector dtype,
# tolerance against the JAX package)
DTYPES = {
    "f64": ("float64", torch.float64, np.float64, jnp.float64, 1e-12),
    "f32": ("float32", torch.float32, np.float32, jnp.float32, 1e-5),
    "bf16": ("bfloat16", torch.float32, jnp.bfloat16, jnp.float32, 1e-5),
}
W = 0.7


def _rel(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


@functools.lru_cache(maxsize=None)
def _problem(kind: str):
    """(scipy M, build args) of a random lattice operator of each kind:
    an operator on 1,500 points embedded in the 24^3 lattice, and an
    interpolation-like M from it onto 1,200 relocated cells (its
    transpose for the restriction)."""
    rng = np.random.default_rng(7)
    if kind == "dia_with_tail":
        npts = 1500
        pos = np.sort(rng.choice(N, size=npts, replace=False))
        rows = rng.integers(0, npts, size=npts * 12)
        cols = np.clip(rows + rng.integers(-40, 41, size=rows.size), 0, npts - 1)
        M = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                          shape=(npts, npts))
        return M, (pos, pos, N)
    npts = 1200
    pts = np.sort(rng.choice(N, size=npts, replace=False))
    ccol = tdia.relocate_to_cells(pts, SHAPE, FACTORS)
    rows = rng.integers(0, N, size=9000)
    near = np.clip(np.searchsorted(pts, rows), 0, npts - 1)
    cols = np.clip(near + rng.integers(-1, 2, size=rows.size), 0, npts - 1)
    M = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)),
                      shape=(N, npts))
    if kind == "parity_restrict":
        M = M.T.tocsr()
    return M, (ccol, SHAPE, FACTORS)


_BUILD = {
    "dia_with_tail": (tdia.build_embedded_dia, jdia.build_embedded_dia, 30),
    "parity_interp": (tdia.build_parity_interp, jdia.build_parity_interp, 4),
    "parity_restrict": (tdia.build_parity_restrict,
                        jdia.build_parity_restrict, 4),
}
# columns of each kind; jacobi is for the square one
_COLS = {"dia_with_tail": N, "parity_interp": NCELLS, "parity_restrict": N}
_FORMS = [(k, f) for k in _COLS for f in ("plain", "resid", "axpy", "jacobi")
          if f != "jacobi" or k == "dia_with_tail"]


@functools.lru_cache(maxsize=None)
def _operator(kind: str, dt: str):
    mdt = DTYPES[dt][0]
    M, args = _problem(kind)
    return _BUILD[kind][0](M, *args, mdt, "cpu", tail_min=_BUILD[kind][2])


@functools.lru_cache(maxsize=None)
def _jax_matvec(kind: str, dt: str, seed: int) -> np.ndarray:
    """The JAX package's spmv of the same operator, under one jit."""
    _, _, jmdt, jvdt, _ = DTYPES[dt]
    M, args = _problem(kind)
    J = _BUILD[kind][1](M, *args, np.dtype(jmdt), tail_min=_BUILD[kind][2])
    x = _vectors(kind, dt, seed)[0]
    return np.asarray(jax.jit(lambda v: jdia.spmv(J, v))(
        jnp.asarray(x.numpy(), jvdt)))


def _vectors(kind: str, dt: str, seed: int):
    """x, then the form's operands (f, u, d > 0) of the operator's rows."""
    vdt = DTYPES[dt][1]
    A = _operator(kind, dt)
    rng = np.random.default_rng(seed)
    v = lambda k: torch.from_numpy(rng.standard_normal(k)).to(vdt)  # noqa: E731
    x, f, u = v(_COLS[kind]), v(A.num_rows), v(A.num_rows)
    d = torch.from_numpy(rng.uniform(0.1, 1.0, A.num_rows)).to(vdt)
    return x, {"plain": {}, "resid": {"f": f}, "axpy": {"u": u},
               "jacobi": {"f": f, "d": d, "w": W}}


def _fused(A, x, form, ops):
    if form == "plain":
        return tdia.spmv(A, x)
    if form == "resid":
        return tdia.spmv_resid(A, x, ops["f"])
    if form == "axpy":
        return tdia.spmv_axpy(A, x, ops["u"])
    return tdia.spmv_jacobi(A, ops["d"], x, ops["f"], W)


def test_operators_carry_tails():
    for kind in _COLS:
        A = _operator(kind, "f64")
        assert A.tail is not None and A.tail.nnz > 0, kind
    P = _operator("parity_interp", "f64")
    assert sum(t is not None for t in P.class_tails) == 8


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind,form", _FORMS)
def test_fused_equals_the_unfused_composition(kind, form, dt):
    A = _operator(kind, dt)
    x, forms = _vectors(kind, dt, 1)
    ops = forms[form]
    got = _fused(A, x, form, ops)
    want = epilogue(form, tdia.spmv_tail_after(A, x), x, **ops)
    assert got.dtype == x.dtype and got.shape == (A.num_rows,)
    if kind != "parity_restrict":
        assert torch.equal(got, want)
    else:  # the tail is summed first, not last: another order
        assert _rel(got, want) <= (1e-13 if dt == "f64" else 1e-6)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("kind,form", _FORMS)
def test_fused_matches_jax(kind, form, dt):
    A = _operator(kind, dt)
    x, forms = _vectors(kind, dt, 2)
    ops = forms[form]
    got = _fused(A, x, form, ops)
    ref = torch.from_numpy(np.array(_jax_matvec(kind, dt, 2)))
    want = epilogue(form, ref, x, **ops)
    assert _rel(got, want) <= DTYPES[dt][4]


@pytest.mark.parametrize("dt", list(DTYPES))
def test_interp_tail_split_keeps_every_entry_once(dt):
    """Each class's tail holds exactly the whole tail's entries on that
    class's fine rows, each row's entries in the whole tail's order, on
    cell rows; merge-then-tail equals split-then-merge bitwise."""
    P = _operator("parity_interp", dt)
    whole = P.tail
    rows = whole.rows_u.long()[whole.seg.long()].numpy()
    cells, par = tdia._cells_of_fine(rows, SHAPE, FACTORS)
    seen = 0
    for p, t in enumerate(P.class_tails):
        m = par == p
        if t is None:
            assert not m.any()
            continue
        rp = t.row_ptr.numpy()
        assert rp.shape == (NCELLS + 1,) and rp[-1] == t.nnz == m.sum()
        trows = np.repeat(np.arange(NCELLS), np.diff(rp))
        assert np.array_equal(trows, cells[m])  # cells rise with fine rows
        assert np.array_equal(t.cols.numpy(), whole.cols.numpy()[m])
        assert torch.equal(t.vals, whole.vals[torch.from_numpy(m)])
        seen += t.nnz
    assert seen == whole.nnz
    x, _ = _vectors("parity_interp", dt, 3)
    Y = torch.zeros(len(P.mats), NCELLS, dtype=x.dtype)
    for b, m in enumerate(P.mats):
        if m.offsets:
            Y[b] = dia_spmv_reference(m.data, m.offsets, x)
    merged = tdia.parity_merge(Y, SHAPE, FACTORS)
    merge_then_tail = tdia.tail_apply(whole, x, merged)
    for b, (m, t) in enumerate(zip(P.mats, P.class_tails)):
        Y[b] = dia_spmv_reference(m.data, m.offsets, x, tail=t.k1())
    assert torch.equal(tdia.parity_merge(Y, SHAPE, FACTORS), merge_then_tail)


@pytest.mark.parametrize("n_rows,nnz", [(500, 3000), (500, 0), (1, 5),
                                        (None, 800)])
def test_row_ptr_is_searchsorted(n_rows, nnz):
    rng = np.random.default_rng(nnz)
    rows = rng.integers(0, n_rows or 300, size=nnz)
    cols = rng.integers(0, 100, size=nnz)
    t = tdia._build_tail(rows, cols, rng.standard_normal(nnz), "float64",
                         "cpu", n_rows=n_rows)
    n = n_rows if n_rows is not None else (int(rows.max()) + 1 if nnz else 0)
    want = np.searchsorted(np.sort(rows), np.arange(n + 1), side="left")
    assert t.row_ptr.dtype == torch.int32
    assert np.array_equal(t.row_ptr.numpy(), want)
    # the same segments as seg_ptr on rows_u
    ptr = t.row_ptr.numpy()
    ru = t.rows_u.numpy()
    assert np.array_equal(ptr[ru], t.seg_ptr.numpy()[:-1])
    assert np.array_equal(ptr[ru + 1], t.seg_ptr.numpy()[1:])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_k1_plain_version_with_no_diagonals_is_the_tail(dt):
    """noff == 0 with a tail: ax = 0 plus the tail, rows without entries
    exactly 0; and a tail with no entries leaves the DIA sum as it is."""
    mdt, vdt = DTYPES[dt][:2]
    rng = np.random.default_rng(4)
    n = 700
    t = tdia._build_tail(rng.integers(0, n, 2000), rng.integers(0, 900, 2000),
                         rng.standard_normal(2000), mdt, "cpu", n_rows=n)
    x = torch.from_numpy(rng.standard_normal(900)).to(vdt)
    data = torch.zeros(0, n, dtype=t.vals.dtype)
    y = dia_spmv_reference(data, (), torch.zeros(n, dtype=vdt),
                           tail=t.k1(x))
    ref = coo_tail_reference(t.vals, t.cols, t.seg_ptr, t.rows_u, x,
                             torch.zeros(n, dtype=vdt))
    assert torch.equal(y, ref)
    empty = tdia._build_tail(np.zeros(0, np.int64), np.zeros(0, np.int64),
                             np.zeros(0), mdt, "cpu", n_rows=n)
    D = torch.from_numpy(rng.standard_normal((3, n))).to(t.vals.dtype)
    xn = torch.from_numpy(rng.standard_normal(n)).to(vdt)
    assert torch.equal(dia_spmv_reference(D, (-5, 0, 9), xn, tail=empty.k1()),
                       dia_spmv_reference(D, (-5, 0, 9), xn))


def test_class_with_only_tail_entries_is_a_launch_without_diagonals():
    """An interpolation class whose entries all went to the tail gets a
    K1 launch of no diagonals carrying its tail (counted), in place of a
    zero fill; a restriction whose entries all went to the tail gets one
    launch, on its first class."""
    shape, factors = (4, 4, 4), (1, 2, 2)
    # class 0 (iy, iz even): 8 entries on one diagonal, kept; class 1
    # (iy odd, iz even): three entries on three diagonals, all tail
    rows = np.array([0, 1, 2, 3, 32, 33, 34, 35, 4, 5, 38])
    cols = np.array([0, 1, 2, 3, 4, 5, 6, 7, 0, 7, 3])
    ccol = np.array([0, 1, 2, 3, 8, 9, 10, 11])
    M = sp.csr_matrix((np.arange(1.0, 12.0), (rows, cols)), shape=(64, 8))
    P = tdia.build_parity_interp(M, ccol, shape, factors, "float64", "cpu",
                                 tail_min=4)
    assert [len(m.offsets) for m in P.mats] == [1, 0, 0, 0]
    assert [t is not None for t in P.class_tails] == [False, True, False, False]
    assert tdia.kernel_launches(P) == {"dia_spmv": 2, "dia_spmv_tail": 1}
    xc = torch.arange(1.0, 17.0, dtype=torch.float64)
    E = sp.csr_matrix((np.arange(1.0, 12.0), (rows, ccol[cols])),
                      shape=(64, 16))
    y = tdia.spmv(P, xc)
    assert np.array_equal(y.numpy(), E @ xc.numpy())
    assert torch.equal(y, tdia.spmv_tail_after(P, xc))
    # a restriction of tail entries alone
    R = tdia.ParityRestrictOp(
        mats=tuple(tdia.dia_from_coo(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                     np.zeros(0), 16, "float64", "cpu")
                   for _ in range(4)),
        fine_shape=shape, factors=factors,
        tail=tdia._build_tail(ccol[cols[8:]], rows[8:], np.array([9.0, 10, 11]),
                              "float64", "cpu", n_rows=16))
    assert tdia.kernel_launches(R) == {"dia_spmv": 1, "dia_spmv_tail": 1}
    xf = torch.arange(1.0, 65.0, dtype=torch.float64)
    Et = sp.csr_matrix((np.array([9.0, 10, 11]), (ccol[cols[8:]], rows[8:])),
                       shape=(16, 64))
    assert np.array_equal(tdia.spmv(R, xf).numpy(), Et @ xf.numpy())


def test_interp_tail_needs_its_class_tails():
    P = _operator("parity_interp", "f64")
    with pytest.raises(ValueError, match="class_tails"):
        tdia.ParityInterpOp(mats=P.mats, fine_shape=P.fine_shape,
                            factors=P.factors, tail=P.tail)


def _cells_problem(dt, k=900, n_cells=2000):
    mdt, vdt, jmdt, jvdt, _ = DTYPES[dt]
    rng = np.random.default_rng(11)
    cells = np.sort(rng.choice(n_cells, size=k, replace=False))
    D = rng.standard_normal((k, k))
    dense = tdia.DenseMatrix(to_device(D, getattr(torch, mdt), "cpu"), k, k)
    J = jdia.ScatterOp(
        jdia.GatherOp(jdia.DenseMatrix(jnp.asarray(D, jmdt), k, k),
                      jnp.asarray(cells, jnp.int32)),
        jnp.asarray(cells, jnp.int32), n_cells)
    x = rng.standard_normal(n_cells)
    return (tdia.on_cells(dense, cells, n_cells, "cpu"), J, cells,
            torch.from_numpy(x).to(vdt), jnp.asarray(x, jvdt))


@pytest.mark.parametrize("dt,tol", [("f64", 1e-12), ("f32", 1e-5),
                                    ("bf16", 1e-4)])
def test_cell_dense_plain_version_matches_jax(dt, tol):
    A, J, cells, x, jx = _cells_problem(dt)
    assert A.row_of_cell.dtype == torch.int32
    roc = A.row_of_cell.numpy()
    assert np.array_equal(np.flatnonzero(roc >= 0), cells)
    assert np.array_equal(roc[cells], np.arange(len(cells)))
    y = cell_dense_reference(A.inner.inner.data, A.inner.pos, A.row_of_cell, x)
    assert y.shape == (2000,) and y.dtype == x.dtype
    assert _rel(y, np.asarray(jdia.spmv(J, jx))) <= tol
    off = np.ones(2000, bool)
    off[cells] = False
    assert not y.numpy()[off].any()
    # the solver's path on the CPU, and the unfused path it replaces
    assert torch.equal(tdia.spmv(A, x), y)
    plain = tdia.ScatterOp(A.inner, A.pos, A.n_out)
    assert torch.equal(tdia.spmv(plain, x), y)


def test_on_cells_refuses_what_is_not_one_cell_a_row():
    D = tdia.DenseMatrix(torch.ones(3, 3, dtype=torch.float64), 3, 3)
    with pytest.raises(ValueError, match="distinct"):
        tdia.on_cells(D, np.array([1, 1, 2]), 5, "cpu")
    with pytest.raises(ValueError, match="one cell a row"):
        tdia.on_cells(D, np.array([1, 2]), 5, "cpu")


def test_wrappers_refuse_cpu_tensors_and_bad_tails():
    A = _operator("dia_with_tail", "f32")
    x = torch.ones(N)
    before = (dia_spmv_cuda.launches, dia_spmv_cuda.tail_launches,
              cell_dense_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmv_cuda(A.dia.data, A.dia.offsets, x, tail=A.tail.k1())
    C, _, _, xc, _ = _cells_problem("f32")
    with pytest.raises(ValueError, match="CUDA"):
        cell_dense_cuda(C.inner.inner.data, C.inner.pos, C.row_of_cell, xc)
    assert (dia_spmv_cuda.launches, dia_spmv_cuda.tail_launches,
            cell_dense_cuda.launches) == before
    ptr, cols, vals, _ = A.tail.k1()
    d, offs = A.dia.data, A.dia.offsets
    with pytest.raises(ValueError, match="ptr"):
        dia_spmv_reference(d, offs, x, tail=(ptr[1:], cols, vals, None))
    with pytest.raises(TypeError, match="int32"):
        dia_spmv_reference(d, offs, x, tail=(ptr.long(), cols, vals, None))
    with pytest.raises(ValueError, match="one"):
        dia_spmv_reference(d, offs, x, tail=(ptr, cols[1:], vals, None))
    with pytest.raises(TypeError, match="dtype|float"):
        dia_spmv_reference(d, offs, x, tail=(ptr, cols, vals.double(), None))
    with pytest.raises(TypeError, match="int32"):
        cell_dense_reference(C.inner.inner.data, C.inner.pos.long(),
                             C.row_of_cell, xc)


def test_the_24_cubed_lattice_hierarchy_runs_every_tail_in_k1():
    """The frozen 24^3 lattice hierarchy (the JAX package's defaults,
    relocation forced at this size): every tailed operator in the forms
    the V-cycle runs equals the unfused composition (bitwise, the
    restriction to 1e-13), and the collapsed coarse solve is an
    on_cells operator."""
    from hypre_tpu_torch.models import laplacian_7pt
    from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions

    amg = BoomerAMG(laplacian_7pt(24, 24, 24), BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, device_rap=False,
        lattice_shape=(24, 24, 24), relocate_min_n2=0), device="cpu")
    rng = np.random.default_rng(8)
    v = lambda k: torch.from_numpy(rng.standard_normal(k))  # noqa: E731
    tailed = 0
    for lvl in amg.levels:
        n = lvl.dinv.shape[0]
        for name, A in (("A", lvl.A), ("P", lvl.P), ("R", lvl.R)):
            if getattr(A, "tail", None) is None:
                continue
            tailed += 1
            x = v(A.num_cols)
            if name == "A":
                f, d = v(n), v(n).abs()
                assert torch.equal(tdia.spmv_resid(A, x, f), epilogue(
                    "resid", tdia.spmv_tail_after(A, x), x, f=f))
                assert torch.equal(tdia.spmv_jacobi(A, d, x, f, W), epilogue(
                    "jacobi", tdia.spmv_tail_after(A, x), x, f=f, d=d, w=W))
            elif name == "P":
                u = v(A.num_rows)
                assert torch.equal(tdia.spmv_axpy(A, x, u), epilogue(
                    "axpy", tdia.spmv_tail_after(A, x), x, u=u))
            else:
                assert _rel(tdia.spmv(A, x), tdia.spmv_tail_after(A, x)) <= 1e-13
    assert tailed > 0
    ci = amg.levels[-1].coarse_inv
    assert isinstance(ci, tdia.ScatterOp) and ci.row_of_cell is not None
    assert tdia.kernel_launches(ci) == {"cell_dense": 1}
