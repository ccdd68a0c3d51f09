"""The port's Krylov solvers on vectors that are not 1-D tensors: struct
vectors (grid-shaped tensors) and vectors of parts (a tuple of a grid
part and a flat part, the sstruct S + U shape; the dict of
tests/test_krylov.py:121), against the JAX package's pytree solvers.

Both packages solve the same operator, applied part by part (a
convection-diffusion stencil on the grid part through each package's
`struct_matvec`, a dense nonsymmetric matrix on the flat part), from the
same right-hand side in f64.  Iteration counts and convergence flags
must be equal; the residual histories and x agree within 1e-10 of
their largest entry, the final relative residual within 1e-10 (XLA and
torch sum the dot products in another order).

On 1-D tensors nothing changed: every solver gives the bits it gave
with the single-op helpers it had before (`torch.dot`, `y + alpha * x`,
...), and a grid-shaped solve gives the bits of the same solve on the
flat view.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.solvers import krylov as jk
from hypre_tpu.struct import StructGrid as JaxGrid
from hypre_tpu.struct import StructMatrix as JaxStructMatrix
from hypre_tpu.struct import struct_matvec as jax_struct_matvec
from hypre_tpu_torch.solvers import krylov as pk
from hypre_tpu_torch.solvers.krylov import common
from hypre_tpu_torch.struct import StructGrid, StructMatrix, struct_matvec
from torch_threads import one_thread  # noqa: F401

SHAPE = (6, 5, 4)
NU = 7  # the flat part's length
SOLVERS = {
    "pcg": ("PCGOptions", dict(two_norm=True)),
    "gmres": ("GMRESOptions", dict(k_dim=5)),
    "flexgmres": ("FlexGMRESOptions", dict(k_dim=5)),
    "lgmres": ("LGMRESOptions", dict(k_dim=10)),
    "cogmres": ("COGMRESOptions", dict(k_dim=5, cgs=2)),
    "bicgstab": ("BiCGSTABOptions", dict()),
    "cgnr": ("CGNROptions", dict()),
}


def stencil(symmetric: bool) -> dict:
    """7-point diffusion (+ upwind convection unless symmetric)."""
    ones = np.ones(SHAPE)
    e = {(0, 0, 0): (9.0 if symmetric else 6.5) * ones}
    for d in range(3):
        for s in (-1, 1):
            o = [0, 0, 0]
            o[d] = s
            e[tuple(o)] = -(1.0 if symmetric else (1.3 if s < 0 else 0.7)) * ones
    return e


@pytest.fixture(scope="module")
def ops():
    """Both packages' part operators (A, A^T) and right-hand sides."""
    rng = np.random.default_rng(3)
    out = {}
    for sym in (True, False):
        e = stencil(sym)
        # A^T of a constant stencil: offset o takes the coefficient of -o
        eT = {o: e[tuple(-v for v in o)] for o in e}
        G = rng.standard_normal((NU, NU)) * 0.2
        U = G @ G.T + 3 * np.eye(NU) if sym else G + 3 * np.eye(NU)
        out[sym] = dict(
            jA=JaxStructMatrix.from_dict(e, JaxGrid(SHAPE)),
            jAT=JaxStructMatrix.from_dict(eT, JaxGrid(SHAPE)),
            A=StructMatrix.from_dict(e, StructGrid(SHAPE), device="cpu"),
            AT=StructMatrix.from_dict(eT, StructGrid(SHAPE), device="cpu"),
            U=U,
        )
    out["bg"] = rng.standard_normal(SHAPE)
    out["bu"] = rng.standard_normal(NU)
    return out


def solve_both(ops, name, kind):
    """(port result, JAX result) of one solve on `kind` vectors."""
    cls, kw = SOLVERS[name]
    kw = dict(kw, tol=1e-10, max_iter=200)
    p = ops[name in ("pcg", "cgnr")]
    Ut = torch.from_numpy(p["U"])
    Uj = jnp.asarray(p["U"])

    def j_grid(M):
        return lambda x: jax_struct_matvec(M, x)

    def t_grid(M):
        return lambda x: struct_matvec(M, x)

    if kind == "grid":
        jA, jAT = j_grid(p["jA"]), j_grid(p["jAT"])
        tA, tAT = t_grid(p["A"]), t_grid(p["AT"])
        jb, tb = jnp.asarray(ops["bg"]), torch.from_numpy(ops["bg"])
    elif kind == "tuple":
        jA = lambda v: (jax_struct_matvec(p["jA"], v[0]), Uj @ v[1])
        jAT = lambda v: (jax_struct_matvec(p["jAT"], v[0]), Uj.T @ v[1])
        tA = lambda v: (struct_matvec(p["A"], v[0]), Ut @ v[1])
        tAT = lambda v: (struct_matvec(p["AT"], v[0]), Ut.T @ v[1])
        jb = (jnp.asarray(ops["bg"]), jnp.asarray(ops["bu"]))
        tb = (torch.from_numpy(ops["bg"]), torch.from_numpy(ops["bu"]))
    else:  # dict, test_krylov.py:121's S + U shape
        jA = lambda v: {"s": jax_struct_matvec(p["jA"], v["s"]), "u": Uj @ v["u"]}
        jAT = lambda v: {"s": jax_struct_matvec(p["jAT"], v["s"]),
                         "u": Uj.T @ v["u"]}
        tA = lambda v: {"s": struct_matvec(p["A"], v["s"]), "u": Ut @ v["u"]}
        tAT = lambda v: {"s": struct_matvec(p["AT"], v["s"]), "u": Ut.T @ v["u"]}
        jb = {"u": jnp.asarray(ops["bu"]), "s": jnp.asarray(ops["bg"])}
        tb = {"u": torch.from_numpy(ops["bu"]), "s": torch.from_numpy(ops["bg"])}
    fn = name.split("_")[0]
    jo = getattr(jk, cls)(**kw)
    to = getattr(pk, cls)(**kw)
    if fn == "cgnr":
        return (pk.cgnr(tA, tAT, tb, opts=to), jk.cgnr(jA, jAT, jb, opts=jo))
    return getattr(pk, fn)(tA, tb, opts=to), getattr(jk, fn)(jA, jb, opts=jo)


def leaves(x):
    if isinstance(x, dict):
        return [np.asarray(x[k]) for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [np.asarray(v) for v in x]
    return [np.asarray(x)]


def assert_match(rt, rj):
    assert rt.num_iterations == int(rj.num_iterations)
    assert rt.converged == bool(rj.converged)
    nt, nj = rt.res_norms.numpy(), np.asarray(rj.res_norms)
    assert np.array_equal(np.isnan(nt), np.isnan(nj))
    m = ~np.isnan(nj)
    assert np.abs(nt[m] - nj[m]).max() <= 1e-10 * np.abs(nj[m]).max()
    xt = [t.numpy() for t in common.tleaves(rt.x)]
    xj = leaves(rj.x)
    assert [a.shape for a in xt] == [a.shape for a in xj]
    scale = max(np.abs(a).max() for a in xj)
    for a, b in zip(xt, xj):
        assert np.abs(a - b).max() <= 1e-10 * scale
    # a relative residual's largest value is the first, about 1
    assert abs(float(rt.rel_residual_norm) - float(rj.rel_residual_norm)) <= 1e-10


@pytest.mark.parametrize("name", sorted(SOLVERS))
@pytest.mark.parametrize("kind", ["grid", "tuple"])
def test_matches_jax_on_structured_vectors(ops, name, kind):
    rt, rj = solve_both(ops, name, kind)
    assert rt.converged
    assert_match(rt, rj)
    if kind == "tuple":
        assert isinstance(rt.x, tuple) and rt.x[0].shape == SHAPE


@pytest.mark.parametrize("name", ["pcg", "gmres"])
def test_dict_vectors_match_jax(ops, name):
    """tests/test_krylov.py:121's shape: {"s": grid, "u": flat}; dict
    parts sum in sorted key order, as JAX flattens a dict."""
    rt, rj = solve_both(ops, name, "dict")
    assert set(rt.x) == {"s", "u"}
    assert_match(rt, rj)


def _old_helpers():
    """The 1-D helpers as they were before structured vectors."""
    return dict(tdot=torch.dot, taxpy=lambda a, x, y: y + a * x,
                tscale=lambda a, x: a * x, tsub=lambda x, y: x - y,
                tzeros_like=torch.zeros_like, tnorm2=lambda x: torch.sqrt(
                    torch.dot(x, x)), twhere=torch.where)


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_1d_bits_unchanged(ops, name, monkeypatch):
    """On 1-D tensors the widened helpers do the old arithmetic: every
    solver's x and history are the bits of the old helpers' solve; and
    a grid-shaped solve's are those of the flat one."""
    p = ops[name in ("pcg", "cgnr")]
    A = p["A"].to_scipy().toarray()
    At = torch.from_numpy(A)
    fn = name.split("_")[0]
    cls, kw = SOLVERS[name]
    opts = getattr(pk, cls)(**dict(kw, tol=1e-10, max_iter=200))
    b = torch.from_numpy(ops["bg"].ravel())

    def run(op, opT, rhs):
        if fn == "cgnr":
            return pk.cgnr(op, opT, rhs, opts=opts)
        return getattr(pk, fn)(op, rhs, opts=opts)

    new = run(lambda x: At @ x, lambda x: At.T @ x, b)
    grid = run(lambda x: (At @ x.reshape(-1)).reshape(SHAPE),
               lambda x: (At.T @ x.reshape(-1)).reshape(SHAPE),
               b.reshape(SHAPE))
    for m in SOLVERS:
        mod = importlib.import_module(f"hypre_tpu_torch.solvers.krylov.{m}")
        for k, v in _old_helpers().items():
            if hasattr(mod, k):
                monkeypatch.setattr(mod, k, v)
    old = run(lambda x: At @ x, lambda x: At.T @ x, b)
    assert new.num_iterations == old.num_iterations == grid.num_iterations > 0
    assert torch.equal(new.x, old.x)
    assert torch.equal(new.res_norms.nan_to_num(-1), old.res_norms.nan_to_num(-1))
    assert grid.x.shape == SHAPE
    assert torch.equal(grid.x.reshape(-1), new.x)
    assert torch.equal(grid.res_norms.nan_to_num(-1), new.res_norms.nan_to_num(-1))


def test_flat_edge_round_trip():
    """FlatEdge: a 1-D tensor is its own flat view; grid and part
    vectors flatten in tdot's order and come back as they were."""
    v = torch.arange(5.0)
    e = common.FlatEdge(v)
    assert e.flat(v) is v and e.unflat(v) is v
    x = {"u": torch.arange(3.0), "s": (torch.ones(2, 2), torch.zeros(1))}
    e = common.FlatEdge(x)
    f = e.flat(x)
    assert torch.equal(f, torch.tensor([1.0, 1, 1, 1, 0, 0, 1, 2]))
    y = e.unflat(f)
    assert list(y) == ["u", "s"] and torch.equal(y["u"], x["u"])
    assert torch.equal(y["s"][0], x["s"][0]) and y["s"][1].shape == (1,)
    assert float(common.tdot(x, x)) == float(torch.dot(f, f))
