"""Level-1 vector ops (port of hypre_tpu/ops/blas1.py; reference:
seq_mv/vector.c, vector_batched.c).

Plain torch ops on the vectors' device.  The mass ops take a stacked
[k, n] tensor, so k dot products (or k axpys) are one matrix-vector
product (vector_batched.c:15-249).
"""

from __future__ import annotations

import torch


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y + alpha * x


def inner_prod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x, y)


def norm2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(inner_prod(x, x))


def scale(alpha, x: torch.Tensor) -> torch.Tensor:
    return alpha * x


def set_constant(x: torch.Tensor, c) -> torch.Tensor:
    return torch.full_like(x, c)


def mass_inner_prod(x: torch.Tensor, Ys: torch.Tensor) -> torch.Tensor:
    """The k dots <x, Ys[i]> in one product; Ys is [k, n]."""
    return Ys @ x


def mass_axpy(alphas: torch.Tensor, Xs: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """y + sum_i alphas[i] Xs[i]; Xs is [k, n] (vector_batched.c:15)."""
    return y + alphas @ Xs
