"""Level-0 AMG setup on the device for lattice (DIA) operators (port of
hypre_tpu/ops/device_setup.py).

With solvers/amg/device_coarsen.py this moves level 0 -> 1 of the setup
(strength, PMIS, classical interpolation with truncation, RAP, the
non-Galerkin filter: the two largest levels) onto the device; the host
pulls back only the CF marker and the compact coarse operator.

  * `device_classical_interp`: modified classical interpolation
    (par_interp.c:631-906, the formulas of solvers/amg/interp.py::
    classical_interp) in shift algebra: for a stencil operator every
    strong-C / strong-F classification, pair sum and distribution term
    is an elementwise product of shifted diagonal rows.  P's offsets
    are a subset of A's (interpolation reaches only strong neighbours
    of A), so P comes out as a DIA operator on the fine lattice.
  * interpolation truncation (hypre_ParCSRMatrixTruncate: keep the
    max_elmts largest |.|, rescale to keep row sums) as a per-point
    top-k over the offset axis.  Ties: equal |.| keep the LOWEST offset
    index, as in the JAX package; hypre's unstable qsort2_abs may keep
    another equal-valued set, so the pattern (not the kept values) can
    differ from the host's where equal weights straddle the cut.
  * `device_rap`: the two-stage Galerkin product AP = A @ P, then
    A_c = P^T @ AP, in shift algebra (|A||P| + |P||AP| terms, the
    SpGEMM's count); each AP row is used as soon as it is made, so the
    extra memory is one [n] row.  The non-Galerkin filter
    (|a| >= tol sqrt(|d_i d_j|), par_nongalerkin.c) and the lumping of
    the dropped mass onto the diagonal run on the device; per-offset
    row maxima go to the host, which drops all-zero offsets.
  * `device_row_stats`: 1 / diag and 1 / l1 row norm of a DIA operator.

The `*_impl` bodies take `shift` (and a global row-max reducer) as
parameters, so a halo-exchange shift can run them on a sharded lattice
(the JAX package's parallel/dist_setup.py does).

All arithmetic is in the dtype of the inputs (f32 on the production
path, f64 on the oracle's), in the JAX package's order of operations:
in f64 the untruncated interpolation is bitwise the host's.

Reference: par_amg_setup.c:27, par_interp.c, par_rap.c:17,
par_nongalerkin.c; GPU precedent par_interp_device.c.
"""

from __future__ import annotations

import torch

from ..solvers.amg.device_coarsen import shift as _shift
from ..solvers.amg.device_coarsen import strength_masks_impl
from .dia import DIAMatrix


def _rowmax(r: torch.Tensor) -> torch.Tensor:
    """Per-offset maximum over the rows: [noff, n] -> [noff]."""
    return r.amax(dim=1)


def _rows_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the offset axis, offsets added in order from zero (the
    JAX package's reduction order)."""
    acc = torch.zeros_like(x[0])
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


def device_classical_interp(data, cf, *, offsets, theta=0.25,
                            max_row_sum=0.9, trunc_factor=0.0, max_elmts=0):
    """Modified classical interpolation of a DIA operator.

    data: [noff, >= n] row-aligned diagonals; cf: integer CF marker
    (1 C / -1 F / -3 isolated F).  Returns (P_data [noff, n], rowmax
    [noff]): P[i, i + off_k] on A's offset list (C rows the identity at
    offset 0, F rows -w / d on strong-C offsets); the caller drops the
    offsets whose rowmax is 0."""
    return classical_interp_impl(
        data, cf, offsets=tuple(int(o) for o in offsets), theta=theta,
        max_row_sum=max_row_sum, trunc_factor=trunc_factor,
        max_elmts=max_elmts, shift=_shift)


def classical_interp_impl(data, cf, *, offsets, theta, max_row_sum,
                          trunc_factor, max_elmts, shift, rowmax_fn=_rowmax):
    """The shift-parameterized body (par_interp.c:631-906).  `rowmax_fn`
    must reduce over all rows when the lattice is sharded."""
    n = cf.shape[0]
    data = data[:, :n]
    noff = len(offsets)
    k0 = offsets.index(0)
    diag = data[k0]

    S = strength_masks_impl(data, offsets, theta, max_row_sum)
    c = cf > 0
    f1 = cf == -1
    SC = torch.stack([S[k] & shift(c, off, fill=False)
                      for k, off in enumerate(offsets)])
    SF = torch.stack([S[k] & shift(f1, off, fill=False)
                      for k, off in enumerate(offsets)])

    sgn = torch.where(diag < 0, -1.0, 1.0).to(data.dtype)
    Aneg = torch.where(sgn[None, :] * data < 0, data, 0.0)
    k_of = {int(o): k for k, o in enumerate(offsets)}

    # pair sums per strong-F offset ok: s[i] = sum over m in C_i of
    # Aneg[i + ok, m], m = i + ok + om (the "sgn_k a_km < 0" filter is in
    # Aneg, the "m in C_i" filter is SC[idx(ok + om), i])
    w = data * SC  # direct strong-C weights
    is_diag = torch.zeros(noff, 1, dtype=torch.bool, device=data.device)
    is_diag[k0] = True
    # weak entries (strong-F ones too) lump onto the diagonal
    d = diag + _rows_sum(torch.where(SC | SF | is_diag, 0.0, data))

    for ok_idx, ok in enumerate(offsets):
        if ok == 0:
            continue
        e = data[ok_idx] * SF[ok_idx]  # a_ik over strong-F edges
        terms = [(om_idx, k_of[int(ok) + int(om)])
                 for om_idx, om in enumerate(offsets)
                 if int(ok) + int(om) in k_of]
        s = torch.zeros(n, dtype=data.dtype, device=data.device)
        for om_idx, kp in terms:
            s = s + shift(Aneg[om_idx], ok) * SC[kp]
        inv = torch.where(s != 0, e / torch.where(s == 0, 1.0, s), 0.0)
        d = d + torch.where((s == 0) & SF[ok_idx], data[ok_idx], 0.0)
        for om_idx, kp in terms:
            w[kp] += inv * shift(Aneg[om_idx], ok) * SC[kp]

    dsafe = torch.where(d == 0, 1.0, d)
    P = torch.where(w != 0, -w / dsafe, 0.0)

    # truncation (hypre_ParCSRMatrixTruncate, rescale = 1)
    if trunc_factor > 0.0 or max_elmts > 0:
        absP = P.abs()
        row_sum = _rows_sum(P)
        keep = P != 0
        if trunc_factor > 0.0:
            keep &= absP >= trunc_factor * absP.amax(dim=0)[None, :]
        if max_elmts > 0:
            vals = torch.where(keep, absP, -1.0)
            kept_topk = torch.zeros_like(keep)
            rows = torch.arange(noff, device=data.device)[:, None]
            for _ in range(max_elmts):
                kbest = vals.argmax(dim=0)  # ties -> the lowest offset index
                has = vals.gather(0, kbest[None])[0] > 0
                onehot = (rows == kbest[None, :]) & has[None, :]
                kept_topk |= onehot
                vals = torch.where(onehot, -1.0, vals)
            keep &= kept_topk
        kept_sum = _rows_sum(torch.where(keep, P, 0.0))
        scale = torch.where(
            kept_sum != 0, row_sum / torch.where(kept_sum == 0, 1.0, kept_sum),
            1.0)
        P = torch.where(keep, P * scale[None, :], 0.0)

    # C rows: the identity at offset 0
    P = torch.where(c[None, :], 0.0, P)
    P[k0] = torch.where(c, 1.0, P[k0])
    return P, rowmax_fn(P.abs())


def _symbolic_offsets(offs_A, offs_B):
    """Sorted distinct {oa + ob}."""
    return tuple(sorted({int(a) + int(b) for a in offs_A for b in offs_B}))


def rap_impl(P, A, *, offs_P, offs_A, offs_AP, offs_out, tol, shift,
             rowmax_fn=_rowmax):
    """The shift-parameterized two-stage RAP with the fused non-Galerkin
    filter (par_rap.c:17; see classical_interp_impl for `shift` and
    `rowmax_fn`).  Returns (out [len(offs_out), n], rowmax): rows whose
    rowmax is 0 can be dropped; the dropped (filtered) mass is lumped
    onto the diagonal; the threshold reads the UNFILTERED diagonal (as
    rap.py::nongalerkin_filter).  tol is taken in P's dtype."""
    n = P.shape[1]
    kout_of = {o: k for k, o in enumerate(offs_out)}
    diag_out = kout_of[0]
    out = torch.zeros(len(offs_out), n, dtype=P.dtype, device=P.device)
    # stage 1, AP[o, i] = sum_{oa + op2 = o} A[oa, i] * P[op2, i + oa], a
    # row at a time; stage 2 adds it at once into
    # out[o - op1, x] += P[op1, x - op1] * AP[o, x - op1]
    for o in offs_AP:
        ap = torch.zeros(n, dtype=P.dtype, device=P.device)
        for ka, oa in enumerate(offs_A):
            for kp2, op2 in enumerate(offs_P):
                if int(oa) + int(op2) == int(o):
                    ap = ap + A[ka] * shift(P[kp2], oa)
        for kp1, op1 in enumerate(offs_P):
            ko = kout_of.get(int(o) - int(op1))
            if ko is not None:
                out[ko] += shift(P[kp1] * ap, -op1)

    if tol > 0.0:
        # every keep mask from the unfiltered values first (a pair's
        # mirror a_ji = out[idx(-o)] at i + o), then the filter in offset
        # order: one bool mask an offset is the only extra memory
        dabs = out[diag_out].abs().sqrt()
        tol_d = tol * dabs  # tol rounded to P's dtype, as JAX's weak scalar
        keep = torch.ones(len(offs_out), n, dtype=torch.bool, device=P.device)
        for ko, o in enumerate(offs_out):
            if o == 0:
                continue
            thr = tol_d * shift(dabs, o)
            keep[ko] = out[ko].abs() >= thr
            kneg = kout_of.get(-o)
            if kneg is not None:
                keep[ko] |= shift(out[kneg], o).abs() >= thr
        lump = torch.zeros(n, dtype=P.dtype, device=P.device)
        for ko, o in enumerate(offs_out):
            if o != 0:
                lump = lump + torch.where(keep[ko], 0.0, out[ko])
                out[ko].masked_fill_(~keep[ko], 0.0)
        out[diag_out] += lump
    return out, rowmax_fn(out.abs())


def device_rap(P_dia: DIAMatrix, A_dia: DIAMatrix, tol: float = 0.0):
    """Galerkin RAP of embedded DIA operators on their device.  Returns
    (out_data [nkept, n], kept_offsets): the symbolic output offsets whose
    filtered rows are all zero are dropped (the row maxima, one small
    read, decide the kept list; the values stay on the device)."""
    offs_P = tuple(int(o) for o in P_dia.offsets)
    offs_A = tuple(int(o) for o in A_dia.offsets)
    n = A_dia.num_rows
    offs_AP = _symbolic_offsets(offs_A, offs_P)
    offs_out = _symbolic_offsets(tuple(-o for o in offs_P), offs_AP)
    out, rowmax = rap_impl(
        P_dia.data[:, :n], A_dia.data[:, :n], offs_P=offs_P, offs_A=offs_A,
        offs_AP=offs_AP, offs_out=offs_out, tol=float(tol), shift=_shift)
    rm = rowmax.cpu().numpy()
    kept = [k for k, o in enumerate(offs_out) if rm[k] > 0 or o == 0]
    return (out[torch.tensor(kept, device=out.device)],
            tuple(offs_out[k] for k in kept))


def device_row_stats(data, *, offsets):
    """(dinv, l1inv) of a DIA operator: 1 / diag and 1 / sum |row|, 0
    where those are 0 (the smoother data an AMG level holds)."""
    diag = data[list(offsets).index(0)]
    l1 = _rows_sum(data.abs())
    dinv = torch.where(diag == 0, 0.0, 1.0 / torch.where(diag == 0, 1.0, diag))
    l1inv = torch.where(l1 == 0, 0.0, 1.0 / torch.where(l1 == 0, 1.0, l1))
    return dinv, l1inv
