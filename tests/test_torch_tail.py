"""The COO tail of the port (ops/tail_kernel.py, ops/dia.py::COOTail)
on the CPU, from numpy-seeded inputs.

Tolerances: `coo_tail_reference` (the plain version the card's kernel is
held against) is bitwise a gather, multiply and in-order sum per row in
numpy, in f64, f32 and bf16/f32 (each product rounded to the vector
dtype, each segment summed from zero in stored order, one add onto y);
`_build_tail` gives the JAX package's rows_u / seg / cols as integers
and its values bitwise after the cast; `tail_apply` agrees with the JAX
package's <= 1e-12 relative in f64 and <= 1e-5 in f32 and bf16/f32
(XLA's segment sum takes another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.ops import dia as jdia
from hypre_tpu_torch.ops import dia as tdia
from hypre_tpu_torch.ops.csr import to_device
from hypre_tpu_torch.ops.tail_kernel import (coo_tail, coo_tail_cuda,
                                             coo_tail_reference)
from torch_threads import one_thread  # noqa: F401

# (storage dtype of vals, torch vector dtype, numpy vector dtype, jax
# vector dtype, tolerance against the JAX package)
DTYPES = {
    "f64": ("float64", torch.float64, np.float64, jnp.float64, 1e-12),
    "f32": ("float32", torch.float32, np.float32, jnp.float32, 1e-5),
    "bf16": ("bfloat16", torch.float32, np.float32, jnp.float32, 1e-5),
}


def _entries(seed, n_rows=900, n_cols=700, nnz=4000, long_rows=3):
    """Unsorted COO entries on n_rows x n_cols; a few rows hold hundreds
    of entries, most rows none or a few."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, size=nnz)
    rows[: 300 * long_rows] = np.repeat(rng.choice(n_rows, long_rows, False), 300)
    cols = rng.integers(0, n_cols, size=nnz)
    vals = rng.standard_normal(nnz)
    return rows.astype(np.int64), cols.astype(np.int64), vals


def _numpy_tail(vals, cols, seg_ptr, rows_u, x, y):
    """Gather, multiply and sum each segment in stored order, in x's
    dtype; then one add onto y."""
    out = y.copy()
    for s, r in enumerate(rows_u):
        acc = x.dtype.type(0)
        for e in range(seg_ptr[s], seg_ptr[s + 1]):
            acc = acc + vals[e].astype(x.dtype) * x[cols[e]]
        out[r] = out[r] + acc
    return out


@pytest.mark.parametrize("dt", list(DTYPES))
def test_plain_version_is_bitwise_gather_multiply_sum(dt):
    mdt, vdt, npdt, _, _ = DTYPES[dt]
    rows, cols, vals = _entries(1)
    T = tdia._build_tail(rows, cols, vals, mdt, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal(700).astype(npdt)
    y = rng.standard_normal(900).astype(npdt)
    got = coo_tail_reference(T.vals, T.cols, T.seg_ptr, T.rows_u,
                             torch.from_numpy(x), torch.from_numpy(y.copy()))
    # the stored values widened exactly (bf16 -> f32 adds zero bits)
    stored = T.vals.to(vdt).numpy()
    want = _numpy_tail(stored, T.cols.numpy(), T.seg_ptr.numpy(),
                       T.rows_u.numpy(), x, y)
    assert got.dtype == vdt
    assert np.array_equal(got.numpy(), want)


def test_plain_version_adds_in_place_and_only_on_its_rows():
    rows, cols, vals = _entries(3)
    T = tdia._build_tail(rows, cols, vals, "float64", "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(700))
    y0 = torch.from_numpy(np.random.default_rng(5).standard_normal(900))
    y = y0.clone()
    out = coo_tail(T.vals, T.cols, T.seg_ptr, T.rows_u, x, y)
    assert out is y  # in place, as the kernel
    untouched = np.ones(900, bool)
    untouched[T.rows_u.numpy()] = False
    assert np.array_equal(y.numpy()[untouched], y0.numpy()[untouched])
    assert (y.numpy()[~untouched] != y0.numpy()[~untouched]).all()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_build_tail_and_apply_match_jax(dt):
    mdt, vdt, _, jvdt, tol = DTYPES[dt]
    rows, cols, vals = _entries(6)
    T = tdia._build_tail(rows, cols, vals, mdt, "cpu")
    J = jdia._build_tail(rows, cols, vals,
                         np.dtype(jnp.bfloat16 if mdt == "bfloat16" else mdt))
    for name in ("rows_u", "seg", "cols"):
        mine, theirs = getattr(T, name), np.asarray(getattr(J, name))
        assert mine.dtype == torch.int32
        assert np.array_equal(mine.numpy(), theirs), name
    bits = lambda a: a.view(np.int16) if a.dtype.name == "bfloat16" else a  # noqa: E731
    tv = T.vals.view(torch.int16) if mdt == "bfloat16" else T.vals
    assert np.array_equal(tv.numpy(), bits(np.asarray(J.vals)))
    # the pointers walk the JAX package's segment index
    ptr = T.seg_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == T.nnz == len(vals)
    assert np.array_equal(np.repeat(np.arange(len(ptr) - 1), np.diff(ptr)),
                          np.asarray(J.seg))
    rng = np.random.default_rng(7)
    x, y = rng.standard_normal(700), rng.standard_normal(900)
    ref = np.asarray(jdia.tail_apply(J, jnp.asarray(x, jvdt), jnp.asarray(y, jvdt)))
    got = tdia.tail_apply(T, torch.from_numpy(x).to(vdt),
                          torch.from_numpy(y.copy()).to(vdt)).numpy()  # in place
    assert np.abs(got - ref).max() / np.abs(ref).max() <= tol


def test_bf16_values_round_once_to_nearest_even():
    """f64 -> f32 -> bf16, nearest even: the tail's values carry the
    bits the DIA fill gives the same number."""
    v = np.array([1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, 1.0 + 2.0**-9, -0.1, 3e-5])
    t = to_device(v, torch.bfloat16, "cpu")
    want = torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(t.view(torch.int16), want.view(torch.int16))
    # ties go to the even mantissa: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6
    assert t[:2].float().tolist() == [1.0, 1.0 + 2.0**-6]
    T = tdia._build_tail(np.arange(5), np.arange(5), v, "bfloat16", "cpu")
    assert torch.equal(T.vals.view(torch.int16), t.view(torch.int16))


def test_empty_tail_adds_nothing():
    z = np.zeros(0, np.int64)
    T = tdia._build_tail(z, z, np.zeros(0), "float64", "cpu")
    assert T.nnz == 0 and T.seg_ptr.tolist() == [0] and T.seg.shape == (0,)
    y = torch.arange(5.0, dtype=torch.float64)
    assert torch.equal(tdia.tail_apply(T, torch.ones(5, dtype=torch.float64),
                                       y.clone()), y)


def test_wrapper_checks_and_dispatch():
    rows, cols, vals = _entries(8)
    T = tdia._build_tail(rows, cols, vals, "float64", "cpu")
    x, y = torch.ones(700, dtype=torch.float64), torch.zeros(900, dtype=torch.float64)
    with pytest.raises(TypeError, match="int32"):
        coo_tail(T.vals, T.cols.long(), T.seg_ptr, T.rows_u, x, y)
    with pytest.raises(ValueError, match="seg_ptr"):
        coo_tail(T.vals, T.cols, T.seg_ptr[:-1], T.rows_u, x, y)
    with pytest.raises(ValueError, match="one dtype"):
        coo_tail(T.vals, T.cols, T.seg_ptr, T.rows_u, x, y.float())
    # a CPU tensor never reaches the kernel's wrapper, which refuses it
    before = coo_tail_cuda.launches
    coo_tail(T.vals, T.cols, T.seg_ptr, T.rows_u, x, y)
    assert coo_tail_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        coo_tail_cuda(T.vals, T.cols, T.seg_ptr, T.rows_u, x, y)
