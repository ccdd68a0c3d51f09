"""The level-1 Galerkin product on the device, for the lattice-embedded
DIA operators (port of hypre_tpu/ops/device_rap.py).

With the level-1 embedding (solvers/amg/boomeramg.py) the embedded
operator A1 = P^T A0 P is computed on the device from the fine DIA
operator A0 and the embedded interpolation P, which the solve needs
there anyway:

  A1[x, x+o] = sum_{kp1,ka,kp2} P[kp1, u] * A0[ka, u] * P[kp2, u+oa]
               evaluated at u = x - op1,  o = -op1 + oa + op2

Every term is a shifted elementwise triple product of diagonal rows.
The host supplies the symbolic plan only (`plan_embedded_rap`): which
(kp1, ka, kp2) terms feed which output offset, and which offsets the
host's non-Galerkin filter kept; the device evaluates the values, the
filter's threshold and the lumping of the dropped mass onto the
diagonal (solvers/amg/rap.py::nongalerkin_filter).

The JAX package loops over output offsets x padded terms inside one
jitted program.  Eagerly that is one launch per term, so here the
terms at one position t of a block of output offsets are evaluated
together: one gather of shifted windows per factor, two products and
one add, for every output offset that has a term t.  Each offset's
terms are still summed in the JAX package's order t = 0, 1, ... from
zero, and the products are rounded as there ((p1 * a) * p2, in the
accumulation dtype), so the values are the same IEEE operations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.errors import arg_error
from .dia import DIAMatrix

# bytes of a block of output rows and its two temporaries (3 x block
# rows x n x accumulation itemsize); with the output and the padded
# inputs the pass stays under 2 GB at 96^3
SCRATCH_BYTES = 1 << 30


def plan_embedded_rap(offs_P, offs_A, offs_out_unf, offs_out_filt):
    """Host-side symbolic planning (the JAX package's, copied).

    offs_P/offs_A: DIA offsets of the embedded P and fine A.
    offs_out_unf: offsets of the UNFILTERED embedded RAP (from the host
      scipy product: exact, so no symbolic superset).
    offs_out_filt: offsets surviving the non-Galerkin filter (the stored
      pattern).  Returns the padded term tables + slot maps.
    """
    offs_P = np.asarray(offs_P, dtype=np.int64)
    offs_A = np.asarray(offs_A, dtype=np.int64)
    unf = np.asarray(sorted(offs_out_unf), dtype=np.int64)
    filt = set(int(o) for o in offs_out_filt)
    pos = {int(o): j for j, o in enumerate(unf)}

    terms = [[] for _ in unf]
    for kp1, op1 in enumerate(offs_P):
        for ka, oa in enumerate(offs_A):
            for kp2, op2 in enumerate(offs_P):
                o = int(-op1 + oa + op2)
                j = pos.get(o)
                if j is not None:
                    terms[j].append((kp1, ka, kp2))
    tmax = max((len(t) for t in terms), default=1) or 1
    nu = len(unf)
    T = np.zeros((nu, tmax, 3), dtype=np.int32)
    valid = np.zeros((nu, tmax), dtype=bool)
    for j, ts in enumerate(terms):
        for t, tri in enumerate(ts):
            T[j, t] = tri
            valid[j, t] = True
    slot = np.full(nu, -1, dtype=np.int32)
    filt_sorted = sorted(filt)
    fpos = {o: i for i, o in enumerate(filt_sorted)}
    for j, o in enumerate(unf):
        if int(o) in fpos:
            slot[j] = fpos[int(o)]
    diag_j = pos.get(0)
    if diag_j is None:
        raise arg_error("RAP without a diagonal offset")
    return dict(
        unf=unf, T=T, valid=valid, slot=slot, diag_j=int(diag_j),
        filt=np.asarray(filt_sorted, dtype=np.int64), tmax=tmax,
    )


def dia_transpose_device(P: DIAMatrix) -> DIAMatrix:
    """Transpose a square DIA operator on its device: R[kr, x] =
    P[kp, x + or] with or = -op, offsets sorted ascending.  Pure
    copies, so bitwise the values of the host-built transpose."""
    n = P.num_rows
    offs = tuple(int(o) for o in P.offsets)
    out = torch.zeros_like(P.data)
    for kr, op in enumerate(reversed(offs)):
        kp = len(offs) - 1 - kr
        lo, hi = max(0, op), min(n, n + op)  # rows x with 0 <= x - op < n
        if lo < hi:
            out[kr, lo:hi] = P.data[kp, lo - op:hi - op]
    return DIAMatrix(data=out, offsets=tuple(-o for o in reversed(offs)),
                     num_rows=n, num_cols=n)


def _windows(rows: torch.Tensor, pad: int, n: int, dtype):
    """Zero-padded copy of `rows` [k, n] in `dtype`, width W = n + 2 pad
    (row r's entry u at r * W + pad + u), and the view of every length-n
    window of its flat storage: windows[s] starts at flat index s."""
    k = rows.shape[0]
    W = n + 2 * pad
    buf = torch.zeros(k, W, dtype=dtype, device=rows.device)
    buf[:, pad:pad + n] = rows.to(dtype)
    return buf.view(-1).unfold(0, n, 1), W


def embedded_rap_device(P_emb: DIAMatrix, A0: DIAMatrix, plan, tol,
                        out_dtype):
    """The filtered embedded RAP on the device of P_emb / A0.

    Returns (data [nfilt, n] out_dtype, diag_unf [n], lump [n]), as
    the JAX function does; the lumped mass is already folded into the
    stored diagonal row of data, which is all the solver keeps (diag_unf
    and lump are returned for the parity tests against the JAX function).
    Rounding as in the JAX package: products and sums in float64 when
    P is float64, else in float32; `tol` is taken as float32 in every
    dtype; offsets the host filter dropped stay dropped; the lumped
    mass is added to the diagonal row after that row was rounded to
    out_dtype and read back as float32, and the sum is rounded again.
    """
    dev = P_emb.data.device
    acc = torch.float64 if P_emb.data.dtype == torch.float64 else torch.float32
    n = A0.num_rows
    offs_P = np.asarray(P_emb.offsets, dtype=np.int64)
    offs_A = np.asarray(A0.offsets, dtype=np.int64)
    unf, T, slot = plan["unf"], plan["T"], plan["slot"]
    diag_j, nout = plan["diag_j"], len(plan["filt"])
    ntot = plan["valid"].sum(1)  # each offset's terms are a prefix of its row
    span = int(max(np.abs(offs_P).max(initial=0) * 2
                   + np.abs(offs_A).max(initial=0),
                   np.abs(unf).max(initial=0)))
    pad = span + 8
    winP, W = _windows(P_emb.data, pad, n, acc)
    winA, _ = _windows(A0.data, pad, n, acc)
    itemsize = torch.finfo(acc).bits // 8
    block = max(1, SCRATCH_BYTES // (3 * n * itemsize))

    def rows_of(js):
        """(unfiltered rows [len(js), n], order): the rows of the output
        offsets js[order], ordered by term count, most first, so that
        those with a term at position t are a prefix; each sums its
        terms t = 0, 1, ... from zero."""
        order = np.argsort(-ntot[js], kind="stable")
        sj = np.asarray(js)[order]
        cnt = ntot[sj]
        tri = T[sj, :int(cnt[0])].astype(np.int64)  # [len, tcount, 3]
        op1 = offs_P[tri[..., 0]]
        # flat window starts of p1[u], a[u], p2[u + oa] at u = x - op1
        starts = np.stack([tri[..., 0] * W + pad - op1,
                           tri[..., 1] * W + pad - op1,
                           tri[..., 2] * W + pad - op1 + offs_A[tri[..., 1]]])
        starts = torch.from_numpy(
            np.ascontiguousarray(starts.transpose(2, 0, 1))).to(dev)
        rows = torch.zeros(len(sj), n, dtype=acc, device=dev)
        for t in range(int(cnt[0])):
            k = int((cnt > t).sum())
            s = starts[t, :, :k]
            g = winP[s[0]]
            g.mul_(winA[s[1]])
            g.mul_(winP[s[2]])
            rows[:k].add_(g)
            del g
        return rows, order

    # pass 1: the unfiltered diagonal (defines the filter threshold)
    diag = rows_of([diag_j])[0][0]
    dabs = torch.sqrt(diag.abs())
    dwin, _ = _windows(dabs[None], pad, n, acc)
    # tol * sqrt|d_i|: tol as float32 (the JAX package's cast), its
    # product in the accumulation dtype
    tol_d = float(np.float32(tol)) * dabs
    out = torch.zeros(nout, n, dtype=out_dtype, device=dev)
    lump = torch.zeros(n, dtype=acc, device=dev)
    for j0 in range(0, len(unf), block):
        rows, order = rows_of(np.arange(j0, min(j0 + block, len(unf))))
        js = j0 + order  # the offsets of the rows, in the rows' order
        # threshold rows: tol * sqrt(|d_i|) * sqrt(|d_{i+o}|)
        thr = dwin[torch.from_numpy(pad + unf[js]).to(dev)].mul_(tol_d)
        sl = slot[js]
        keep = rows.abs() >= thr
        del thr
        keep &= torch.from_numpy(sl >= 0).to(dev)[:, None]
        keep[torch.from_numpy(js == diag_j).to(dev)] = True
        dropped = torch.where(keep, 0.0, rows)
        for r in np.argsort(order):  # lumped in offset order, as there
            lump = lump + dropped[r]
        del dropped
        rows.masked_fill_(~keep, 0.0)
        del keep
        stored = np.flatnonzero(sl >= 0)
        if len(stored):
            out[torch.from_numpy(sl[stored].astype(np.int64)).to(dev)] = (
                rows[torch.from_numpy(stored).to(dev)].to(out_dtype))
        del rows
    dslot = int(np.searchsorted(plan["filt"], 0))
    out[dslot] = (out[dslot].to(torch.float32) + lump).to(out_dtype)
    return out, diag, lump
