"""Krylov solver plumbing — the vtable analog (port of
hypre_tpu/solvers/krylov/common.py).

The reference writes each Krylov method once against a function-pointer
vtable {Matvec, InnerProd, Axpy, ...} (krylov/pcg.h:49-70).  Here solvers
take `A` and `M` as callables; the helpers below are the InnerProd /
Axpy slots.  A vector is a tensor of any shape (a struct vector is the
grid-shaped array), or a tuple, list or dict of such parts (an sstruct
vector's parts), as the JAX package's pytree helpers take them:
  * `tdot` of a tensor is the dot of its flat view (`jnp.vdot`); of a
    container, the sum of its parts' dots in order (a dict's parts in
    sorted key order, as JAX flattens a dict), each part's dot moved to
    the first part's device before it is added;
  * the elementwise helpers map over the parts; a 0-d scalar (a dot, a
    step length) is moved to a part's device where the two differ, so
    the parts of a sharded vector (parallel/) may live on several cards.
On a 1-D tensor every helper is the single torch op it always was, and
on parts that share one device nothing is moved.

The GMRES family keeps its Krylov basis as one stacked tensor; it runs
on the flat view of its vectors (`FlatEdge`), which on a 1-D tensor is
the tensor itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

Vec = Any  # a tensor, or a tuple / list / dict of tensors


def tmap(fn: Callable, x: Vec, *ys: Vec) -> Vec:
    """fn over the parts of x (and the matching parts of ys)."""
    if isinstance(x, torch.Tensor):
        return fn(x, *ys)
    if isinstance(x, dict):
        return {k: tmap(fn, x[k], *(y[k] for y in ys)) for k in x}
    if isinstance(x, (tuple, list)):
        return type(x)(tmap(fn, *p) for p in zip(x, *ys))
    raise TypeError(f"not a Krylov vector: {type(x).__name__}")


def tleaves(x: Vec) -> list:
    """The tensors of x in the order `tdot` sums them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tleaves(x[k])]
    return [t for p in x for t in tleaves(p)]


def tfirst(x: Vec) -> torch.Tensor:
    """x's first tensor: its dtype and device are the solve's."""
    return tleaves(x)[0]


def tdot(x: Vec, y: Vec) -> torch.Tensor:
    """<x, y> (the InnerProd vtable slot), a 0-d tensor on x's device."""
    if isinstance(x, torch.Tensor):
        return torch.dot(x.reshape(-1), y.reshape(-1))
    acc = None
    for a, b in zip(tleaves(x), tleaves(y)):
        d = torch.dot(a.reshape(-1), b.reshape(-1))
        acc = d if acc is None else acc + _on(d, acc.device)
    return acc


def _on(alpha, device):
    """alpha on `device`: a tensor elsewhere is moved, anything else kept."""
    if isinstance(alpha, torch.Tensor) and alpha.device != device:
        return alpha.to(device)
    return alpha


def taxpy(alpha, x: Vec, y: Vec) -> Vec:
    return tmap(lambda a, b: b + _on(alpha, a.device) * a, x, y)


def tscale(alpha, x: Vec) -> Vec:
    return tmap(lambda a: _on(alpha, a.device) * a, x)


def tsub(x: Vec, y: Vec) -> Vec:
    return tmap(torch.sub, x, y)


def tadd(x: Vec, y: Vec) -> Vec:
    return tmap(torch.add, x, y)


def tzeros_like(x: Vec) -> Vec:
    return tmap(torch.zeros_like, x)


def twhere(cond: torch.Tensor, x: Vec, y: Vec) -> Vec:
    """x where the 0-d flag holds, else y, part by part."""
    return tmap(lambda a, b: torch.where(_on(cond, a.device), a, b), x, y)


def tnorm2(x: Vec) -> torch.Tensor:
    return torch.sqrt(tdot(x, x))


def identity_precond(r: Vec) -> Vec:
    return r


class FlatEdge:
    """The flat view of a vector's structure, for solvers that stack a
    basis: `flat(v)` is one 1-D tensor (v itself when v is 1-D, a view
    when it is one tensor, the parts concatenated in `tdot`'s order
    otherwise), `unflat` inverts it, and `wrap` gives an operator on
    flat vectors."""

    def __init__(self, like: Vec):
        self.like = like
        self.shapes = [t.shape for t in tleaves(like)]

    def flat(self, v: Vec) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v if v.dim() == 1 else v.reshape(-1)
        return torch.cat([t.reshape(-1) for t in tleaves(v)])

    def unflat(self, f: torch.Tensor) -> Vec:
        if isinstance(self.like, torch.Tensor):
            return f if self.like.dim() == 1 else f.reshape(self.like.shape)
        parts = iter(torch.split(f, [s.numel() for s in self.shapes]))
        return _rebuild(self.like, parts)

    def wrap(self, op: Callable[[Vec], Vec]) -> Callable:
        if isinstance(self.like, torch.Tensor) and self.like.dim() == 1:
            return op
        return lambda f: self.flat(op(self.unflat(f)))


def flat_problem(A, b: Vec, x0, M):
    """(edge, A, b, x0, M) of the same problem on flat vectors."""
    edge = FlatEdge(b)
    return (edge, edge.wrap(A), edge.flat(b),
            None if x0 is None else edge.flat(x0),
            edge.wrap(M or identity_precond))


def _rebuild(like: Vec, parts) -> Vec:
    if isinstance(like, torch.Tensor):
        return next(parts).reshape(like.shape)
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], parts) for k in sorted(like)}
        return {k: out[k] for k in like}
    return type(like)(_rebuild(p, parts) for p in like)


@dataclasses.dataclass
class SolverResult:
    """What hypre exposes via GetNumIterations / GetFinalRelativeResidualNorm
    / logging>1 residual histories (pcg.h:139-141)."""

    x: Vec
    num_iterations: int
    rel_residual_norm: torch.Tensor  # 0-d, on the solve's device
    converged: bool
    res_norms: torch.Tensor  # [max_iter + 1] per-iteration ||r||, NaN beyond
