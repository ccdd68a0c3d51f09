"""The fused SpMV forms (resid, axpy, jacobi; ops/forms.py) on the CPU,
against the JAX package and against the port's own unfused sequence.

The JAX side computes the same quantities as its V-cycle does:
`f - spmv(A, u)`, `U + spmv(P, e)` and `relax.jacobi`, on the CPU (its
DIA SpMV through the XLA shift path, its ELL SpMV through the gather).
The port's operators come two ways: carried from the JAX layout with
`convert`, and from the port's own freeze.  Tolerances against JAX:
1e-12 relative in f64, 1e-6 with bf16 data and f32 vectors (both widen
the same bf16 values; XLA and torch may sum in another order).  Against
the port's unfused sequence the plain versions are bitwise equal.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch_ragged import ragged

from hypre_tpu.ops.csr import CSRMatrix as JCSR
from hypre_tpu.ops.dia import csr_to_dia as jax_csr_to_dia
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.solvers.amg.relax import jacobi as jax_jacobi
from hypre_tpu_torch.convert import levels_from_numpy
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import (CSRMatrix, DenseMatrix, DIAMatrix, ELLMatrix,
                                 spmv, spmv_axpy, spmv_jacobi, spmv_resid)
from hypre_tpu_torch.ops import dia as dia_mod
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.ops.dia_kernel import (dia_spmv_cuda, launch_plan,
                                            rows_per_thread,
                                            vector_path)
from hypre_tpu_torch.ops.ell_kernel import ell_spmv_cuda, slot_lanes
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.amg.relax import jacobi

W = 0.7  # the Jacobi weight


def banded(n, offsets, seed):
    """n x n CSR with random values on the given diagonals."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for o in offsets:
        i = np.arange(max(0, -o), min(n, n - o))
        rows.append(i)
        cols.append(i + o)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                         shape=(n, n))


OPERATORS = {
    # DIA: the 7-point pattern (compile-time offsets on the card) and 12
    # random offsets (the generic path)
    "dia7": lambda: banded(700, (-81, -9, -1, 0, 1, 9, 81), seed=1),
    "dia12": lambda: banded(600, tuple(int(o) for o in np.unique(
        np.random.default_rng(2).integers(-200, 200, 12))), seed=2),
    # ELL: square (A), tall (P, width 4), wide (R, width 35)
    "square": lambda: ragged(900, 900, 37, seed=3),
    "tall": lambda: ragged(1000, 350, 4, seed=4),
    "wide": lambda: ragged(350, 1000, 35, seed=5),
}
FORM_CASES = [(op, form) for op in OPERATORS
              for form in ("resid", "axpy", "jacobi")
              if form != "jacobi" or op in ("dia7", "dia12", "square")]
DTYPES = {"f64": (np.float64, np.float64, "float64", 1e-12),
          "bf16": (jnp.bfloat16, np.float32, "bfloat16", 1e-6)}


def jax_operator(M, op, mdt):
    if op.startswith("dia"):
        return jax_csr_to_dia(JCSR.from_scipy(M), dtype=mdt, device=False)
    return JCSR.from_scipy(M).to_ell(dtype=mdt, device=False, transposed=True)


def carried(jM):
    """The port's operator carried from the JAX layout by `convert`."""
    n = jM.num_rows
    lvl = SimpleNamespace(A=jM, dinv=np.ones(n), l1inv=np.ones(n),
                          cmask=np.ones(n, dtype=bool), P=None, R=None,
                          coarse_inv=None)
    return levels_from_numpy([lvl], "cpu")[0].A


def port_operator(M, op, mdt_name):
    if op.startswith("dia"):
        return csr_to_dia(CSRMatrix.from_scipy(M), mdt_name, "cpu")
    return CSRMatrix.from_scipy(M).to_ell(mdt_name, "cpu")


def vectors(M, vdt, seed):
    """Seeded x [cols], f, u, d [rows] (d > 0, as D^{-1} is)."""
    rng = np.random.default_rng(seed)
    n, m = M.shape
    return (rng.standard_normal(m).astype(vdt),
            rng.standard_normal(n).astype(vdt),
            rng.standard_normal(n).astype(vdt),
            rng.uniform(0.1, 1.0, n).astype(vdt))


def rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / np.abs(ref).max()


def port_form(A, form, x, f, u, d):
    if form == "resid":
        return spmv_resid(A, x, f)
    if form == "axpy":
        return spmv_axpy(A, x, u)
    return spmv_jacobi(A, d, x, f, W)


@pytest.mark.parametrize("source", ["carried", "port"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op,form", FORM_CASES)
def test_forms_match_jax(op, form, dt, source):
    mdt, vdt, mdt_name, tol = DTYPES[dt]
    M = OPERATORS[op]()
    jM = jax_operator(M, op, mdt)
    A = carried(jM) if source == "carried" else port_operator(M, op, mdt_name)
    assert isinstance(A, DIAMatrix if op.startswith("dia") else ELLMatrix)
    x, f, u, d = vectors(M, vdt, seed=len(op) + len(form))
    if form == "resid":
        ref = jnp.asarray(f) - jax_spmv(jM, jnp.asarray(x))
    elif form == "axpy":
        ref = jnp.asarray(u) + jax_spmv(jM, jnp.asarray(x))
    else:
        ref = jax_jacobi(jM, jnp.asarray(d), jnp.asarray(x), jnp.asarray(f),
                         W)
    t = torch.from_numpy
    y = port_form(A, form, t(x), t(f), t(u), t(d))
    assert y.shape == (M.shape[0],) and y.dtype == t(x).dtype
    assert rel_err(y, ref) <= tol


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op,form", FORM_CASES + [
    ("dense", "resid"), ("dense", "axpy"), ("dense", "jacobi")])
def test_forms_are_bitwise_the_unfused_sequence(op, form, dt):
    """On the CPU each form is the plain SpMV followed by today's
    elementwise ops, in today's order: bitwise."""
    _, vdt, mdt_name, _ = DTYPES[dt]
    if op == "dense":
        M = sp.csr_matrix(np.random.default_rng(6).standard_normal((60, 60)))
        A = DenseMatrix(data=torch.from_numpy(M.toarray()).to(
            getattr(torch, mdt_name)), num_rows=60, num_cols=60)
    else:
        M = OPERATORS[op]()
        A = port_operator(M, op, mdt_name)
    x, f, u, d = (torch.from_numpy(v) for v in vectors(M, vdt, seed=9))
    y = port_form(A, form, x, f, u, d)
    if form == "resid":
        ref = f - spmv(A, x)
    elif form == "axpy":
        ref = u + spmv(A, x)
    else:
        r = f - spmv(A, x)
        ref = x + W * d * r
        assert torch.equal(jacobi(A, d, x, f, W), ref)
    assert torch.equal(y, ref)


@pytest.mark.parametrize("op", ["square", "tall", "wide"])
def test_row_len_of_to_ell_equals_the_derived_one(op):
    """to_ell fills row_len from the CSR row counts; an ELLMatrix built
    without one (the carried JAX layout) derives the same on its
    device."""
    M = OPERATORS[op]()
    mine = CSRMatrix.from_scipy(M).to_ell("float64", "cpu")
    jM = jax_operator(M, op, np.float64)
    theirs = carried(jM)
    assert theirs.row_len.dtype == torch.int32
    assert np.array_equal(mine.row_len.numpy(), np.diff(M.indptr))
    assert torch.equal(theirs.row_len, mine.row_len)
    assert int(mine.row_len.max()) == mine.data.shape[0]


def test_ell_matrix_checks_row_len():
    cols = torch.zeros(3, 10, dtype=torch.int32)
    data = torch.zeros(3, 10, dtype=torch.float64)
    E = ELLMatrix(cols=cols, data=data, num_rows=10, num_cols=4, nnz=0)
    assert torch.equal(E.row_len, torch.zeros(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_len"):
        ELLMatrix(cols=cols, data=data, num_rows=10, num_cols=4, nnz=0,
                  row_len=torch.zeros(10, dtype=torch.int64))
    with pytest.raises(ValueError, match="row_len"):
        ELLMatrix(cols=cols, data=data, num_rows=10, num_cols=4, nnz=0,
                  row_len=torch.zeros(9, dtype=torch.int32))


@pytest.mark.parametrize("bad", [4, -1])
def test_ell_matrix_checks_row_len_range(bad):
    """The kernel trusts row_len: an entry past the width (3) or below
    0 is refused when the matrix is built."""
    cols = torch.zeros(3, 10, dtype=torch.int32)
    data = torch.zeros(3, 10, dtype=torch.float64)
    row_len = torch.full((10,), 3, dtype=torch.int32)
    ELLMatrix(cols=cols, data=data, num_rows=10, num_cols=4, nnz=0,
              row_len=row_len)
    row_len[7] = bad
    with pytest.raises(ValueError, match=r"row_len entries must lie in \[0, 3\]"):
        ELLMatrix(cols=cols, data=data, num_rows=10, num_cols=4, nnz=0,
                  row_len=row_len)


def _wrapper_calls():
    """(wrapper name, call(x, **operands)) for a 7-point DIA and a tall
    ELL operator, float32 on the CPU."""
    D = csr_to_dia(laplacian_7pt(5, 4, 3), "float32", "cpu")
    P = CSRMatrix.from_scipy(ragged(60, 25, 4, seed=8)).to_ell("float32", "cpu")
    return {
        "dia": (D.num_rows, D.num_rows,
                lambda x, form, **k: dia_spmv_cuda(D.data, D.offsets, x, form, **k)),
        "ell": (P.num_rows, P.num_cols,
                lambda x, form, **k: ell_spmv_cuda(P.data, P.cols, P.row_len,
                                                   x, form, **k)),
    }


@pytest.mark.parametrize("kernel", ["dia", "ell"])
def test_wrappers_reject_wrong_form_operands(kernel):
    n, m, call = _wrapper_calls()[kernel]
    x = torch.ones(m)
    v = torch.ones(n)
    with pytest.raises(ValueError, match="length"):
        call(x, "resid", f=torch.ones(n + 1))
    with pytest.raises(ValueError, match="device"):
        call(x, "axpy", u=torch.ones(n, device="meta"))
    with pytest.raises(TypeError, match="float64"):
        call(x, "resid", f=v.double())
    with pytest.raises(ValueError, match="contiguous"):
        call(x, "axpy", u=torch.ones(2 * n)[::2])
    with pytest.raises(ValueError, match="missing"):
        call(x, "axpy")
    with pytest.raises(ValueError, match="extra"):
        call(x, "plain", f=v)
    with pytest.raises(ValueError, match="unknown form"):
        call(x, "sor", f=v)
    # a well-formed call with CPU tensors: the kernel needs the card
    with pytest.raises(ValueError, match="CUDA"):
        call(x, "resid", f=v)


def test_ell_lanes_must_be_a_kernel_instantiation():
    P = CSRMatrix.from_scipy(ragged(60, 25, 4, seed=8)).to_ell("float64", "cpu")
    with pytest.raises(ValueError, match="lanes"):
        ell_spmv_cuda(P.data, P.cols, P.row_len,
                      torch.ones(25, dtype=torch.float64), lanes=3)


def test_ell_jacobi_needs_a_square_operator():
    P = CSRMatrix.from_scipy(ragged(60, 25, 4, seed=8)).to_ell("float64", "cpu")
    with pytest.raises(ValueError, match="square"):
        ell_spmv_cuda(P.data, P.cols, P.row_len, torch.ones(25, dtype=torch.float64),
                      "jacobi", f=torch.ones(60, dtype=torch.float64),
                      d=torch.ones(60, dtype=torch.float64))


@pytest.mark.parametrize("width,n,lanes", [
    # the 96^3 f64 hierarchy's ELL operators
    (4, 884_736, 1), (7, 274_940, 1), (37, 274_940, 4), (4, 274_940, 1),
    (35, 56_657, 4), (68, 56_657, 8), (4, 56_657, 4), (39, 10_058, 16),
    (107, 10_058, 16), (4, 10_058, 4), (39, 1_529, 16),
    # bf16/f32 hierarchy: L1 A, L2 A
    (33, 274_940, 4), (35, 56_681, 4),
])
def test_slot_lanes(width, n, lanes):
    """One lane a row for the operators that fill the card one thread a
    row, 4-8 lanes for the wide operators of the upper levels (at most
    16 slots a lane), 16 on the small levels."""
    assert slot_lanes(width, n) == lanes


@pytest.mark.parametrize("n,offsets,plan", [
    # the 96^3 fine level: by value, 32-bit
    (884_736, (-9216, -96, -1, 0, 1, 96, 9216), (True, False)),
    # 7 offsets with noff * n past 2^31 (17 GB of f64 diagonals): still
    # by value, 64-bit
    (310_000_000, (-9216, -96, -1, 0, 1, 96, 9216), (True, True)),
    # an offset that takes x's index past 2^31
    (1000, (0, 2**31), (True, True)),
    # more than 8 offsets: the device array
    (4096, tuple(range(-4, 5)), (False, False)),
    (300_000_000, tuple(range(-4, 5)), (False, True)),
])
def test_k1_launch_plan(n, offsets, plan):
    """(offsets by value, 64-bit indices): up to 8 offsets go by value
    at any n; the index width follows the largest index, not the
    count."""
    assert launch_plan(n, offsets) == plan


def test_dia_vector_path():
    assert [rows_per_thread(torch.empty(1, 1, dtype=dt)) for dt in
            (torch.bfloat16, torch.float32, torch.float64)] == [8, 4, 2]
    data = torch.zeros(7, 884_736, dtype=torch.bfloat16)
    x = torch.zeros(884_736)
    assert vector_path(884_736, data, x, None)
    odd = torch.zeros(7, 2431)
    assert not vector_path(2431, odd, torch.zeros(2431))
    # a vector that does not start on 16 bytes takes the scalar path
    assert not vector_path(884_736, data, torch.zeros(884_737)[1:])


def test_vcycle_uses_the_fused_forms(monkeypatch):
    """One V-cycle at 20^3 (L0 DIA, L0 P/R ELL, the rest dense): the
    residual and the up-smooth go through DIA forms, the prolongation
    through the ELL axpy, the restriction through the plain ELL SpMV."""
    opts = BoomerAMGOptions(
        coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
        relax_down=18, relax_up=18, embed_level1=False,
        relocate_level2=False, collapse_coarse_n=0, dtype="float64")
    amg = BoomerAMG(laplacian_7pt(20, 20, 20), opts, device="cpu")
    assert isinstance(amg.levels[0].A, DIAMatrix)
    assert isinstance(amg.levels[0].P, ELLMatrix)
    calls = []
    for name in ("dia_spmv", "ell_spmv"):
        real = getattr(dia_mod, name)

        def spy(A, x, form="plain", _name=name, _real=real, **ops):
            calls.append((_name, form))
            return _real(A, x, form, **ops)

        monkeypatch.setattr(dia_mod, name, spy)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(8000))
    amg.cycle(b)
    assert sorted(calls) == sorted([
        ("dia_spmv", "resid"), ("ell_spmv", "plain"), ("ell_spmv", "axpy"),
        ("dia_spmv", "jacobi")])
