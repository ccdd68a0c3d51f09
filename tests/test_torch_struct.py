"""The port's struct interface (hypre_tpu_torch/struct/) against the JAX
package's (hypre_tpu/struct/), on the cases of tests/test_struct.py and
tests/test_multibox.py.

Host pieces are held bitwise: the box algebra, the grid, `to_scipy` /
`from_scipy`, `to_struct_matrix`, `distribute_PB`.  Device pieces
(`shift`, `struct_matvec`, `multibox_matvec`) are held within 1e-12 of
the JAX package's in f64, relative to the largest entry: `shift` and a
matvec of one offset bitwise, the sums of several offsets not (XLA may
contract a multiply-add that torch rounds twice, and torch's `add_` with
a factor may fuse it).  The convert.py carriers bring a JAX StructMatrix
(constant entries and periodic flags included) and a multi-box grid and
vector across unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.struct import StructGrid as JaxGrid
from hypre_tpu.struct import StructMatrix as JaxStructMatrix
from hypre_tpu.struct import box as jbox
from hypre_tpu.struct import multibox as jmb
from hypre_tpu.struct.matrix import shift as jax_shift
from hypre_tpu.struct.matrix import struct_matvec as jax_struct_matvec
from hypre_tpu_torch import convert
from hypre_tpu_torch.struct import (StructGrid, StructMatrix, box,
                                    struct_inner_prod, struct_matvec)
from hypre_tpu_torch.struct import multibox as mb
from hypre_tpu_torch.struct.matrix import shift
from torch_threads import one_thread  # noqa: F401

TOL = 1e-12
OFFS7 = [(0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
         (0, 0, -1), (0, 0, 1)]


def both(entries, shape, periodic=None):
    """(port, JAX) StructMatrix of the same entries."""
    return (StructMatrix.from_dict(entries, StructGrid(shape, periodic),
                                   device="cpu"),
            JaxStructMatrix.from_dict(entries, JaxGrid(shape, periodic)))


def poisson7(shape, c=(1.0, 1.0, 1.0)):
    ones = np.ones(shape)
    e = {(0, 0, 0): 2 * sum(c) * ones}
    for d in range(3):
        for s in (-1, 1):
            o = [0, 0, 0]
            o[d] = s
            e[tuple(o)] = -c[d] * ones
    return e


def close(a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300)


# -- boxes, grids ------------------------------------------------------------

def _rand_box(rng, mod, lo=-6, hi=8):
    a = rng.integers(lo, hi, size=3)
    b = rng.integers(lo, hi, size=3)
    return mod.Box(tuple(int(v) for v in np.minimum(a, b)),
                   tuple(int(v) for v in np.maximum(a, b)))


def test_box_algebra_matches_jax():
    """subtract / intersect / grow / union_size / bounding_box, fuzzed:
    the same boxes as the JAX package's, and the disjoint-cover laws."""
    rng_t, rng_j = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(300):
        a, b = _rand_box(rng_t, box), _rand_box(rng_t, box)
        ja, jb = _rand_box(rng_j, jbox), _rand_box(rng_j, jbox)
        diff = box.subtract_boxes(a, b)
        jdiff = jbox.subtract_boxes(ja, jb)
        assert [(d.imin, d.imax) for d in diff] == [(d.imin, d.imax) for d in jdiff]
        inter = a.intersect(b)
        assert sum(d.size for d in diff) + inter.size == a.size
        for d in diff:
            assert a.contains(d) and d.intersect(b).empty
        assert box.union_size([a, b]) == jbox.union_size([ja, jb])
        g = a.grow((1, 0, 2))
        assert (g.imin, g.imax) == (ja.grow((1, 0, 2)).imin, ja.grow((1, 0, 2)).imax)
    bb = box.bounding_box([box.Box((0, 1, 2), (3, 3, 3)), box.Box((5, 0, 0), (6, 1, 1))])
    assert (bb.imin, bb.imax) == ((0, 0, 0), (6, 3, 3))
    assert box.bounding_box([]).empty
    ba = box.BoxArray([a, b])
    assert len(ba) == 2 and ba.size == a.size + b.size and ba[0] is a


def test_box_manager_and_distribution():
    """test_multibox.py's region query and emptyproc distribution: the
    same owners and boxes as the JAX package's."""
    for n, P, B, npr in [((4, 4, 4), (2, 2, 1), (1, 1, 1), 4),
                         ((6, 6, 6), (2, 1, 2), (2, 2, 2), 7)]:
        owners, g = box.distribute_PB(n, P, B, npr)
        jowners, jg = jbox.distribute_PB(n, P, B, npr)
        assert [(r, b.imin, b.imax) for r, b in owners] == [
            (r, b.imin, b.imax) for r, b in jowners]
        assert g.shape == jg.shape
        assert box.union_size([b for _, b in owners]) == g.size
    bm = box.BoxManager(3)
    for rank, b in box.distribute_PB((4, 4, 4), (2, 2, 1), (1, 1, 1), 4)[0]:
        bm.add_entry(b, rank)
    bm.assemble()
    assert len(bm.intersect(box.Box((3, 3, 0), (4, 4, 0)))) == 4
    assert bm.intersect(box.Box((9, 9, 9), (9, 9, 9))) == []
    assert [e.owner for e in bm.gather_all()] == [0, 1, 2, 3]


def test_grid_coarsen_periodic():
    for shape, per, cdir in [((7, 6, 5), (0, 6, 0), 1), ((8, 3), (8, 0), 0),
                             ((9, 4, 2), None, 2)]:
        g, jg = StructGrid(shape, per), JaxGrid(shape, per)
        assert (g.size, g.ndim, g.periodic) == (jg.size, jg.ndim, jg.periodic)
        c, jc = g.coarsen(cdir), jg.coarsen(cdir)
        assert (c.shape, c.periodic) == (jc.shape, jc.periodic)


# -- shift, matvec ------------------------------------------------------------

@pytest.mark.parametrize("periodic", [None, (6, 0, 4)])
def test_shift_bitwise(periodic):
    """The JAX package's bits for offsets shorter than the axis; a
    longer one reads only zeros off a non-periodic axis (the JAX
    package's `shift` pads such an axis to another length, so it is not
    compared there)."""
    x = np.random.default_rng(1).standard_normal((6, 5, 4))
    for off in [(1, 0, 0), (0, -2, 0), (-1, 1, 3), (5, 0, 0), (0, 0, -3)]:
        got = shift(torch.from_numpy(x), off, periodic).numpy()
        assert np.array_equal(got, np.asarray(jax_shift(jnp.asarray(x), off, periodic)))
    far = shift(torch.from_numpy(x), (0, 7, 0), periodic).numpy()
    assert far.shape == x.shape and not far.any()


def test_matvec_matches_jax_and_scipy():
    """test_struct.py's variable 7-point stencil: within 1e-12 of the JAX
    package's matvec and of the assembled scipy matrix; alpha / beta."""
    A, jA = both(poisson7((5, 4, 3), (1.0, 2.0, 3.0)), (5, 4, 3))
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((5, 4, 3)), rng.standard_normal((5, 4, 3))
    got = struct_matvec(A, torch.from_numpy(x)).numpy()
    close(got, jax_struct_matvec(jA, jnp.asarray(x)))
    close(got.ravel(), A.to_scipy() @ x.ravel())
    got = struct_matvec(A, torch.from_numpy(x), alpha=-0.5, beta=2.0,
                        y=torch.from_numpy(y)).numpy()
    close(got, jax_struct_matvec(jA, jnp.asarray(x), -0.5, 2.0, jnp.asarray(y)))


def test_matvec_one_offset_bitwise():
    """One offset: one product, no sum; the bits of the JAX package's."""
    rng = np.random.default_rng(2)
    ent = {(1, 0, -1): rng.standard_normal((5, 4, 3))}
    A, jA = both(ent, (5, 4, 3))
    x = rng.standard_normal((5, 4, 3))
    assert np.array_equal(struct_matvec(A, torch.from_numpy(x)).numpy(),
                          np.asarray(jax_struct_matvec(jA, jnp.asarray(x))))


def test_matvec_periodic():
    shape = (6, 4, 1)
    ones = np.ones(shape)
    ent = {(0, 0, 0): 4 * ones, (-1, 0, 0): -ones, (1, 0, 0): -ones,
           (0, -1, 0): -ones, (0, 1, 0): -2 * ones}
    A, jA = both(ent, shape, (6, 4, 0))
    x = np.random.default_rng(1).standard_normal(shape)
    got = struct_matvec(A, torch.from_numpy(x)).numpy()
    close(got, jax_struct_matvec(jA, jnp.asarray(x)))
    close(got.ravel(), A.to_scipy() @ x.ravel())


BOXED_CASES = {
    "3-D variable": ((5, 4, 3), None, OFFS7 + [(1, 0, -1), (-2, 1, 0)]),
    "2-D": ((7, 6), None, [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (1, 1)]),
    "periodic x": ((6, 4, 3), (6, 0, 0), OFFS7 + [(-1, 1, 0)]),
    "offset past the axis": ((4, 3, 5), None, [(0, 0, 0), (0, 4, 0), (-5, 0, 1)]),
}


@pytest.mark.parametrize("case", sorted(BOXED_CASES))
def test_boxed_matvec_is_the_grid_matvec(case):
    """`boxed` zeroes the taps that leave the box along the non-periodic
    axes (checked against numpy's mask of those taps) and marks the
    matrix; its flat-run matvec, with the constant entries, gives the
    bits of the grid-slice matvec of the matrix it came from.  Boxing
    twice, or boxing data that is already zero there, copies nothing."""
    shape, per, offs = BOXED_CASES[case]
    rng = np.random.default_rng(5)
    ent = {o: rng.standard_normal(shape) for o in offs}
    ent[tuple(-o for o in offs[1])] = -1.5  # a constant entry
    A = StructMatrix.from_dict(ent, StructGrid(shape, per), device="cpu")
    B = A.boxed()
    assert B.in_box and not A.in_box and B.boxed() is B
    idx = np.indices(shape)
    for k, off in enumerate(A.offsets):
        ok = np.ones(shape, bool)
        for d, (o, p) in enumerate(zip(off, per or (0,) * len(shape))):
            if not p:
                ok &= (idx[d] + o >= 0) & (idx[d] + o < shape[d])
        assert np.array_equal(B.data[k].numpy(),
                              np.where(ok, A.data[k].numpy(), 0.0))
    assert B.boxed().data is B.data
    C = dataclasses.replace(B, in_box=False).boxed()
    assert C.data is B.data
    x = torch.from_numpy(rng.standard_normal(shape))
    assert torch.equal(struct_matvec(B, x), struct_matvec(A, x))
    y = torch.from_numpy(rng.standard_normal(shape))
    assert torch.equal(struct_matvec(B, x, -0.5, 2.0, y),
                       struct_matvec(A, x, -0.5, 2.0, y))


@pytest.mark.parametrize("kind", ["constant", "mixed", "periodic_constant"])
def test_constant_coefficients(kind):
    """Constant entries are Python floats (no data array) and give the
    variable stencil's product; mixed variable / constant stencils too."""
    shape = (8, 6, 5)
    per = (8, 0, 0) if kind == "periodic_constant" else None
    ent = {o: (6.0 if o == (0, 0, 0) else -1.0 - 0.25 * sum(o)) for o in OFFS7}
    if kind == "mixed":
        ent[(0, 0, 0)] = 6.0 + np.random.default_rng(3).random(shape)
    A, jA = both(ent, shape, per)
    assert A.data.shape[0] == (1 if kind == "mixed" else 0)
    assert A.const_offsets == jA.const_offsets
    assert A.const_values == jA.const_values
    x = np.random.default_rng(0).standard_normal(shape)
    got = struct_matvec(A, torch.from_numpy(x)).numpy()
    close(got, jax_struct_matvec(jA, jnp.asarray(x)))
    close(got.ravel(), A.to_scipy() @ x.ravel())
    ones = np.ones(shape)
    Av = StructMatrix.from_dict({o: v * ones for o, v in ent.items()},
                                StructGrid(shape, per), device="cpu")
    close(got, struct_matvec(Av, torch.from_numpy(x)).numpy())
    D = A.densify()
    assert D.const_offsets == () and D.offsets == jA.densify().offsets
    assert np.array_equal(D.data.numpy(), np.asarray(jA.densify().data))
    assert np.array_equal(A.entry((1, 0, 0)).numpy(), np.asarray(jA.entry((1, 0, 0))))
    assert np.array_equal(A.diagonal().numpy(), np.asarray(jA.diagonal()))
    assert A.all_offsets == jA.all_offsets


def test_scipy_round_trip():
    """to_scipy is the JAX package's matrix; from_scipy recovers the
    stencil (np.unique offset order) as the JAX package does."""
    ent = poisson7((4, 3, 2), (1.0, 2.0, 3.0))
    ent[(1, 1, 0)] = np.random.default_rng(4).standard_normal((4, 3, 2))
    A, jA = both(ent, (4, 3, 2))
    M = A.to_scipy()
    assert (M != jA.to_scipy()).nnz == 0
    B = StructMatrix.from_scipy(M, (4, 3, 2), device="cpu")
    jB = JaxStructMatrix.from_scipy(M, (4, 3, 2))
    assert B.offsets == jB.offsets
    assert np.array_equal(B.data.numpy(), np.asarray(jB.data))
    assert (B.to_scipy() != M).nnz == 0


def test_inner_prod():
    rng = np.random.default_rng(5)
    x, y = rng.standard_normal((4, 5, 6)), rng.standard_normal((4, 5, 6))
    got = float(struct_inner_prod(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - float(np.vdot(x, y))) <= 1e-13 * np.abs(x * y).sum()


# -- multi-box --------------------------------------------------------------

@pytest.mark.parametrize("P,B", [((2, 1, 2), (1, 1, 1)),
                                 ((2, 2, 1), (2, 1, 2))])
def test_multibox_matvec_matches_jax(P, B):
    """test_multibox.py: the multi-box matvec (ghost plans from box
    intersections) against the JAX package's and the canonical matvec."""
    owners, gbox = box.distribute_PB((4, 4, 4), P, B, int(np.prod(P)))
    grid = mb.MultiBoxGrid([b for _, b in owners])
    jowners, _ = jbox.distribute_PB((4, 4, 4), P, B, int(np.prod(P)))
    jgrid = jmb.MultiBoxGrid([b for _, b in jowners])
    assert grid.is_rectangular()
    plans, jplans = grid.ghost_plans(1), jgrid.ghost_plans(1)
    assert [[(c.src, c.src_slc, c.dst_slc) for c in p] for p in plans] == [
        [(c.src, c.src_slc, c.dst_slc) for c in p] for p in jplans]
    shape = gbox.shape
    rng = np.random.default_rng(1)
    glob = {o: rng.standard_normal(shape) for o in OFFS7}
    ent_mb = {o: {i: glob[o][grid.boxes[i].slice_in(gbox)]
                  for i in grid.nonempty} for o in OFFS7}
    xt = rng.standard_normal(shape)
    y = mb.multibox_matvec(grid, ent_mb, mb.MultiBoxVector.from_global(
        grid, xt, device="cpu")).to_global().numpy()
    jy = np.asarray(jmb.multibox_matvec(jgrid, ent_mb, jmb.MultiBoxVector
                                        .from_global(jgrid, xt)).to_global())
    close(y, jy)
    A = StructMatrix.from_dict(glob, StructGrid(shape), device="cpu")
    close(y, struct_matvec(A, torch.from_numpy(xt)).numpy())


def test_nonrectangular_union_embedding():
    """An L-shaped union: to_struct_matrix's embedding (identity
    exterior) and union mask are the JAX package's bitwise, and the
    embedded matvec equals the multi-box one on the union."""
    boxes = [((0, 0, 0), (7, 3, 4)), ((0, 4, 0), (3, 7, 4))]
    grid = mb.MultiBoxGrid([box.Box(*b) for b in boxes])
    jgrid = jmb.MultiBoxGrid([jbox.Box(*b) for b in boxes])
    assert not grid.is_rectangular()
    ent_mb = {o: {} for o in OFFS7}
    rng = np.random.default_rng(6)
    for i in grid.nonempty:
        for o in OFFS7:
            ent_mb[o][i] = rng.standard_normal(grid.boxes[i].shape)
    ent, inside = mb.to_struct_matrix(grid, ent_mb)
    jent, jinside = jmb.to_struct_matrix(jgrid, ent_mb)
    assert np.array_equal(inside, jinside)
    assert np.array_equal(mb.union_mask(grid), inside)
    for o in OFFS7:
        assert np.array_equal(ent[o], jent[o])
    A = StructMatrix.from_dict(ent, StructGrid(grid.bbox.shape), device="cpu")
    xt = rng.standard_normal(grid.bbox.shape) * inside
    y_mb = mb.multibox_matvec(grid, ent_mb, mb.MultiBoxVector.from_global(
        grid, xt, device="cpu")).to_global().numpy()
    close(y_mb, struct_matvec(A, torch.from_numpy(xt)).numpy() * inside)


# -- the carriers -------------------------------------------------------------

def test_convert_struct_matrix_round_trip():
    """A JAX StructMatrix with variable and constant entries and a
    periodic axis crosses to the port unchanged (its bits, its static
    fields), applies the same stencil, and crosses back."""
    shape = (6, 4, 3)
    rng = np.random.default_rng(7)
    ent = {(0, 0, 0): 6.0 + rng.random(shape), (-1, 0, 0): -1.0,
           (1, 0, 0): -1.5, (0, -1, 0): rng.standard_normal(shape),
           (0, 1, 0): -0.5, (0, 0, 1): -2.0}
    jA = JaxStructMatrix.from_dict(ent, JaxGrid(shape, (6, 0, 0)))
    A = convert.struct_matrix_from_numpy(jA, "cpu")
    assert (A.offsets, A.periodic, A.const_offsets, A.const_values,
            A.shape) == (jA.offsets, jA.periodic, jA.const_offsets,
                         jA.const_values, tuple(jA.shape))
    assert np.array_equal(A.data.numpy(), np.asarray(jA.data))
    assert (A.to_scipy() != jA.to_scipy()).nnz == 0
    x = rng.standard_normal(shape)
    close(struct_matvec(A, torch.from_numpy(x)).numpy(),
          jax_struct_matvec(jA, jnp.asarray(x)))
    back = JaxStructMatrix(
        data=jnp.asarray(A.data.numpy()), offsets=A.offsets,
        periodic=A.periodic, const_offsets=A.const_offsets,
        const_values=A.const_values, _shape=A._shape)
    assert (back.to_scipy() != jA.to_scipy()).nnz == 0


def test_convert_multibox():
    owners, gbox = jbox.distribute_PB((3, 3, 2), (2, 1, 2), (1, 2, 1), 6)
    jgrid = jmb.MultiBoxGrid([b for _, b in owners] + [jbox.Box((0, 0, 0),
                                                                (-1, 0, 0))])
    grid = convert.multibox_grid_from(jgrid)
    assert [(b.imin, b.imax) for b in grid.boxes] == [
        (b.imin, b.imax) for b in jgrid.boxes]
    assert grid.nonempty == jgrid.nonempty and grid.periodic == jgrid.periodic
    xt = np.random.default_rng(8).standard_normal(gbox.shape)
    jv = jmb.MultiBoxVector.from_global(jgrid, xt)
    v = convert.multibox_vector_from(jv, "cpu", grid)
    assert v.grid is grid
    assert np.array_equal(v.to_global().numpy(), np.asarray(jv.to_global()))
    assert np.array_equal(v.to_global().numpy(), xt)
