"""Cyclic reduction — direct solver for 1-D (tridiagonal) struct systems
(port of hypre_tpu/solvers/struct_ls/cyclic_reduction.py).

Reference: struct_ls/cyclic_reduction.c (the 1-D coarsest-level direct
solver used under SMG).

PARALLEL cyclic reduction (PCR): ceil(log2 n) elimination sweeps, each
elementwise over all lines at once, batched over any leading dims, so a
[ny, nz] stack of lines solves in the same log-depth.  The sweeps are a
host loop of `torch.roll`s (the JAX package's `fori_loop`); the bands'
part of the elimination can be done once for many right-hand sides
(`pcr_factor`, `pcr_apply`), which the 2-D SMG's line solves do.
"""

from __future__ import annotations

import numpy as np
import torch

from ...struct.matrix import StructMatrix


def pcr_factor(lower, diag, upper):
    """The elimination of PCR on fixed bands along the LAST axis:
    ([(k, alpha[..., k:], gamma[..., :n-k])] for each sweep, the final
    diagonal with its zero pivots guarded as 1).  Only the right-hand
    side's recurrence depends on the right-hand side, so a level's
    factor is computed once and applied to every right-hand side
    (`pcr_apply`); the values are those the one-pass form computes.
    lower[...,0] and upper[...,n-1] are ignored (out of band); a pivot
    that is 0 divides as 1 (the JAX package's guards)."""
    n = diag.shape[-1]
    a = torch.cat([torch.zeros_like(lower[..., :1]), lower[..., 1:]], -1)
    c = torch.cat([upper[..., :-1], torch.zeros_like(upper[..., :1])], -1)
    b = diag

    steps = max(1, int(np.ceil(np.log2(max(n, 2)))))
    idx = torch.arange(n, device=diag.device)
    sweeps = []
    for s in range(steps):
        k = 1 << s
        ok_m = idx - k >= 0
        ok_p = idx + k < n
        bk, b_k = _sh(b, k), _sh(b, -k)
        bm = torch.where(bk == 0, 1.0, bk)
        bp = torch.where(b_k == 0, 1.0, b_k)
        alpha = torch.where(ok_m, -a / bm, 0.0)
        gamma = torch.where(ok_p, -c / bp, 0.0)

        b = b + alpha * _sh(c, k) + gamma * _sh(a, -k)
        a = alpha * _sh(a, k)
        c = gamma * _sh(c, -k)
        m = max(n - k, 0)
        sweeps.append((k, alpha.narrow(-1, min(k, n), m).contiguous(),
                       gamma.narrow(-1, 0, m).contiguous()))
    return sweeps, torch.where(b == 0, 1.0, b)


def pcr_apply(factor, rhs):
    """Solve with a `pcr_factor` for the right-hand sides rhs [..., n].
    Each sweep is d + alpha d[i - k] + gamma d[i + k], summed in that
    order, over the points where the neighbour exists (elsewhere alpha
    or gamma is 0): two in-place products on runs of a copy of d."""
    sweeps, b = factor
    d = rhs
    n = rhs.shape[-1]
    for k, a_hi, g_lo in sweeps:
        m = max(n - k, 0)
        nxt = d.clone()
        nxt.narrow(-1, min(k, n), m).addcmul_(a_hi, d.narrow(-1, 0, m))
        nxt.narrow(-1, 0, m).addcmul_(g_lo, d.narrow(-1, min(k, n), m))
        d = nxt
    return d / b


def _sh(x, off):
    return torch.roll(x, off, -1)


def pcr_solve_batched(lower, diag, upper, rhs):
    """Solve tridiagonal systems along the LAST axis via PCR.

    lower/diag/upper/rhs: [..., n]; lower[...,0] and upper[...,n-1]
    ignored (out of band).
    """
    return pcr_apply(pcr_factor(lower, diag, upper), rhs)


class CyclicReduction:
    """Direct solve of a 1-D StructMatrix (3-point stencil)."""

    def __init__(self, A: StructMatrix, *, device=None):
        """`device`: where the bands live and the solve runs (None: A's
        device)."""
        shape = tuple(A.shape)
        if sum(s > 1 for s in shape) > 1:
            raise ValueError("cyclic reduction is 1-D")
        self.axis = int(np.argmax(shape))
        self.A = A if device is None else A.to(device)
        nd = len(shape)

        def entry(off_val):
            off = [0] * nd
            off[self.axis] = off_val
            off = tuple(off)
            # constant entries too (the JAX package looks only at the
            # variable ones, and fails on a constant band)
            if off in self.A.all_offsets:
                return torch.movedim(self.A.entry(off), self.axis, -1)
            return torch.zeros(shape[self.axis], dtype=self.A.dtype,
                               device=self.A.device)[None]

        self._factor = pcr_factor(entry(-1), entry(0), entry(1))

    def solve(self, b):
        bm = torch.movedim(b, self.axis, -1)
        x = pcr_apply(self._factor, bm)
        return torch.movedim(x, -1, self.axis)
