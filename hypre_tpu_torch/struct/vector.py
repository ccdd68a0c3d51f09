"""Struct vector helpers (port of hypre_tpu/struct/vector.py; reference:
struct_mv/struct_vector.c, struct_innerprod.c — a BoxLoop reduction +
Allreduce; here one dot over the grid-shaped tensor)."""

import torch


def struct_inner_prod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.dot(x.reshape(-1), y.reshape(-1))
