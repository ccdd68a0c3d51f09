"""The epilogue forms of the SpMV kernels (K1 and the ELL SpMV).

Each kernel computes A x and, in the same launch, one of

    plain    y = A x
    resid    y = f - A x                   residual before restriction
    axpy     y = u + A x                   prolongation, u + P e
    jacobi   y = u + (w * d) * (f - A u)   weighted (l1-)Jacobi sweep, x = u

`epilogue` is the plain torch form of the same elementwise work: the
ops, in the order, that `relax.py::jacobi` and `BoomerAMG.cycle` ran on
an unfused matvec, so a plain version that ends in it gives bitwise the
results the unfused code gave.  `check_operands` is the kernels'
wrappers' check of the form's operands against x.
"""

from __future__ import annotations

import torch

FORMS = ("plain", "resid", "axpy", "jacobi")
# the vectors each form takes besides x; jacobi's u is x itself
OPERANDS = {"plain": (), "resid": ("f",), "axpy": ("u",),
            "jacobi": ("f", "d")}


def epilogue(form: str, y: torch.Tensor, x: torch.Tensor, f=None, u=None,
             d=None, w=1.0) -> torch.Tensor:
    """The form's elementwise work on y = A x (jacobi reads u = x)."""
    if form == "plain":
        return y
    if form == "resid":
        return f - y
    if form == "axpy":
        return u + y
    if form == "jacobi":
        r = f - y
        return x + w * d * r
    raise ValueError(f"unknown SpMV form {form!r}; one of {FORMS}")


def check_operands(name: str, form: str, x: torch.Tensor, n: int,
                   f=None, u=None, d=None) -> None:
    """Raise unless exactly the form's operands are given, each a
    contiguous [n] tensor of x's dtype on x's device."""
    if form not in OPERANDS:
        raise ValueError(f"{name}: unknown form {form!r}; one of {FORMS}")
    need = OPERANDS[form]
    for key, t in (("f", f), ("u", u), ("d", d)):
        if (t is None) == (key in need):
            raise ValueError(
                f"{name}: form {form!r} takes {need or 'no vectors'} "
                f"besides x; {key} is {'missing' if t is None else 'extra'}")
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(
                f"{name}: device mismatch: {key} {t.device}, x {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(
                f"{name}: {key} is {t.dtype}, x is {x.dtype}")
        if t.shape != (n,):
            raise ValueError(
                f"{name}: {key} has shape {tuple(t.shape)}, the form needs "
                f"length {n} (the operator's rows)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
