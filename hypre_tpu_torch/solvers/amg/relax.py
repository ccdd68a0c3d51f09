"""Jacobi-family smoothers (port of hypre_tpu/solvers/amg/relax.py:
jacobi, jacobi_cf, l1_jacobi).

Reference: parcsr_ls/par_relax.c — relax 0/7 weighted Jacobi, 5 chaotic
GS (order-free on a data-parallel machine == Jacobi), 18 l1-Jacobi.
"""

from __future__ import annotations

import torch

from ...ops.dia import spmv, spmv_jacobi


def jacobi(A, dinv, u, f, weight=1.0):
    """u += weight * D^{-1} (f - A u)   (par_relax.c case 0, all points);
    one kernel launch on the card for DIA and ELL operators."""
    return spmv_jacobi(A, dinv, u, f, weight)


def jacobi_cf(A, dinv, u, f, mask, weight=1.0):
    """CF-Jacobi: update only rows where mask (C then F gives CF-GS)."""
    r = f - spmv(A, u)
    return torch.where(mask, u + weight * dinv * r, u)


def l1_jacobi(A, l1inv, u, f, weight=1.0):
    """relax 18: u += (f - A u) / l1   (par_relax.c:3492 family)."""
    return jacobi(A, l1inv, u, f, weight)
