"""Strength and PMIS coarsening on the device for lattice (DIA) operators
(port of hypre_tpu/solvers/amg/device_coarsen.py).

Reference: par_strength.c hypre_BoomerAMGCreateS + par_coarsen.c
hypre_BoomerAMGCoarsenPMISHost (:2031-2738), and their *_device.c GPU
counterparts.

For a stencil operator stored as diagonals every PMIS ingredient is an
elementwise or shift computation, with no gathers:
  * strength: per-offset strict-inequality tests against the row scale
    (max / min of the off-diagonal entries, an elementwise reduction
    over the diagonal rows);
  * measures: S^T column counts, shifted sums of the S masks;
  * the iterated independent set: neighbour comparisons over S u S^T,
    per-offset shifted lexicographic compares of (count, lcg_state).
Measures are compared as the INTEGER pair (strong-transpose count,
Park-Miller state): count + state / M orders as (count, state) does, so
the CF marker is bitwise the host's `pmis_coarsen` with no floating
point ties.  The LCG states come from the host's skip-ahead as int32.

`device_pmis` runs the loop as a Python `while` with one host read an
iteration (the JAX package runs one `lax.while_loop`); the CF marker
stays on the device.  `lattice_pmis_host` is its numpy twin, the
check.
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils.lcg import _POW2, lcg_skip
from ...utils.lcg import M as _LCG_M

_PMIS_SEED = 2747


def lcg_states_host(seed: int, n: int, skip: int = 0) -> np.ndarray:
    """The n int32 Park-Miller STATES hypre_Rand would traverse
    (state / M is the returned real; state order is value order)."""
    if n == 0:
        return np.empty(0, dtype=np.int32)
    out = np.empty(n, dtype=np.int64)
    out[0] = lcg_skip(seed, skip + 1)
    # doubling fill: out[2^j .. 2^(j+1)) = out[0 .. 2^j) * a^(2^j)
    filled, j = 1, 0
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = (out[:take] * _POW2[j]) % _LCG_M
        filled += take
        j += 1
    return out.astype(np.int32)


def shift(x: torch.Tensor, off: int, fill=0) -> torch.Tensor:
    """y[i] = x[i + off], `fill` outside (off static)."""
    n = x.shape[0]
    off = int(off)
    if off == 0:
        return x
    y = torch.full_like(x, fill)
    if abs(off) < n:
        if off > 0:
            y[:n - off] = x[off:]
        else:
            y[-off:] = x[:n + off]
    return y


def strength_masks_impl(data, offsets, theta, max_row_sum) -> torch.Tensor:
    """Per-offset strong masks S_k[i] ("row i strongly depends on
    i + off_k"), bool [noff, n], with strength_matrix's strict tests.
    Row-local: it reads only row i's entries, so it needs no shift."""
    diag = data[offsets.index(0)]
    neg = diag < 0
    row_max = torch.zeros_like(diag)
    row_min = torch.zeros_like(diag)
    for k, off in enumerate(offsets):
        if off != 0:
            row_max = torch.maximum(row_max, data[k])
            row_min = torch.minimum(row_min, data[k])
    thresh = theta * torch.where(neg, row_max, row_min)
    rs = torch.zeros_like(diag)
    for k in range(len(offsets)):
        rs = rs + data[k]
    weak_row = (rs.abs() > diag.abs() * max_row_sum if max_row_sum < 1.0
                else torch.zeros_like(neg))
    masks = torch.zeros(len(offsets), diag.shape[0], dtype=torch.bool,
                        device=data.device)
    for k, off in enumerate(offsets):
        if off != 0:
            masks[k] = torch.where(neg, data[k] > thresh,
                                   data[k] < thresh) & ~weak_row
    return masks


def _np_shift(x, off, fill=0):
    """numpy twin of `shift`."""
    n = x.shape[0]
    off = int(off)
    if off == 0:
        return x
    out = np.full(n, fill, dtype=x.dtype)
    if off > 0:
        out[: n - off] = x[off:]
    else:
        out[-off:] = x[: n + off]
    return out


def lattice_pmis_host(data, offsets, n, seed: int = _PMIS_SEED,
                      theta: float = 0.25, max_row_sum: float = 0.9):
    """Host (numpy) twin of `device_pmis` for a DIA lattice operator: the
    same integer-pair measure comparisons, rounds and ties, so the CF
    marker is bitwise `device_pmis`'s and `coarsen.pmis_coarsen`'s.  It
    takes the values in float32, as the JAX package's twin does."""
    data = np.asarray(data)[:, :n].astype(np.float32)
    offsets = tuple(int(o) for o in offsets)
    lcg = lcg_states_host(seed, n)

    diag_k = offsets.index(0)
    diag = data[diag_k]
    neg = diag < 0
    row_max = np.zeros_like(diag)
    row_min = np.zeros_like(diag)
    for k, off in enumerate(offsets):
        if off == 0:
            continue
        np.maximum(row_max, data[k], out=row_max)
        np.minimum(row_min, data[k], out=row_min)
    thresh = np.float32(theta) * np.where(neg, row_max, row_min)
    rs = data.sum(axis=0, dtype=np.float32)
    weak_row = (np.abs(rs) > np.abs(diag) * np.float32(max_row_sum)
                if max_row_sum < 1.0 else np.zeros(n, bool))
    S = np.zeros((len(offsets), n), dtype=bool)
    for k, off in enumerate(offsets):
        if off == 0:
            continue
        s = np.where(neg, data[k] > thresh, data[k] < thresh)
        S[k] = s & ~weak_row

    cnt = np.zeros(n, np.int32)
    for k, off in enumerate(offsets):
        if off != 0:
            cnt += _np_shift(S[k].astype(np.int32), -off)
    isolated = ~S.any(axis=0)
    cf = np.where(isolated, np.int8(-3), np.int8(0))
    in_graph = ~isolated
    cnt = np.where(isolated, 0, cnt).astype(np.int32)

    adj_offs = sorted({o for o in offsets if o != 0} |
                      {-o for o in offsets if o != 0})
    k_of = {o: k for k, o in enumerate(offsets)}

    def adj_mask(off):
        m = np.zeros(n, bool)
        if off in k_of:
            m |= S[k_of[off]]
        if -off in k_of:
            m |= _np_shift(S[k_of[-off]], off)
        return m

    it = 0
    while in_graph.any() and it < 500:
        cand = in_graph & (cnt >= 1)
        dominated = np.zeros(n, bool)
        ccnt = np.where(cand, cnt, 0).astype(np.int32)
        clcg = np.where(cand, lcg, 0).astype(np.int32)
        for off in adj_offs:
            nb_cand = _np_shift(cand, off, fill=False)
            nb_cnt = _np_shift(ccnt, off)
            nb_lcg = _np_shift(clcg, off)
            better = (nb_cnt > cnt) | ((nb_cnt == cnt) & (nb_lcg > lcg))
            dominated |= adj_mask(off) & nb_cand & better
        in_is = cand & ~dominated
        cf = np.where(in_is, np.int8(1), cf)

        is_c = cf > 0
        newly_f = in_graph & (cnt < 1)
        infl_c = np.zeros(n, bool)
        for k, off in enumerate(offsets):
            if off == 0:
                continue
            infl_c |= S[k] & _np_shift(is_c, off, fill=False)
        newly_f |= in_graph & ~is_c & infl_c
        cf = np.where(in_graph & is_c, np.int8(1), cf)
        cf = np.where(newly_f, np.int8(-1), cf)
        settled = in_graph & (cf != 0)
        cnt = np.where(settled, 0, cnt).astype(np.int32)
        in_graph = in_graph & (cf == 0)
        it += 1
    return cf.astype(np.int8)


def device_pmis(data, offsets, n, seed: int = _PMIS_SEED,
                theta: float = 0.25, max_row_sum: float = 0.9):
    """CF marker (int8 on data's device: 1 C, -1 F, -3 isolated) of a
    DIA stencil operator, bitwise `coarsen.pmis_coarsen` on the same
    matrix.  `data` [noff, >= n] row-aligned diagonals."""
    offsets = tuple(int(o) for o in offsets)
    lcg = torch.from_numpy(lcg_states_host(seed, n)).to(data.device)
    return pmis_impl(data[:, :n], lcg, offsets=offsets, n=n, theta=theta,
                     max_row_sum=max_row_sum, shift=shift,
                     any_fn=lambda m: bool(m.any()))


def pmis_impl(data, lcg, *, offsets, n, theta, max_row_sum, shift, any_fn):
    """Shift-parameterized PMIS body.  `shift(x, off, fill)` supplies
    neighbour values (`shift` above on one device; a halo exchange on a
    sharded lattice).  `any_fn` returns a Python bool and must be a
    GLOBAL any when sharded: every shard has to run the same number of
    rounds."""
    S = strength_masks_impl(data, offsets, theta, max_row_sum)
    dev = data.device

    # S^T column counts: cnt[i] = sum_k S_k[i - off_k]
    cnt = torch.zeros(n, dtype=torch.int32, device=dev)
    for k, off in enumerate(offsets):
        if off != 0:
            cnt = cnt + shift(S[k].to(torch.int32), -off)
    isolated = ~S.any(0)
    cf = torch.where(isolated, -3, 0).to(torch.int8)
    in_graph = ~isolated
    cnt = torch.where(isolated, 0, cnt)

    # adjacency offsets of S u S^T: i ~ i + off iff S_off[i] (dependence)
    # or S_{-off}[i + off] (influence)
    adj_offs = sorted({o for o in offsets if o != 0} |
                      {-o for o in offsets if o != 0})
    k_of = {o: k for k, o in enumerate(offsets)}
    adj = {}
    for off in adj_offs:
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        if off in k_of:
            m = m | S[k_of[off]]
        if -off in k_of:
            m = m | shift(S[k_of[-off]], off, fill=False)
        adj[off] = m

    it = 0
    while it < 500 and any_fn(in_graph):
        cand = in_graph & (cnt >= 1)  # measure > 1 <=> count >= 1 (rand < 1)
        ccnt = torch.where(cand, cnt, 0)
        clcg = torch.where(cand, lcg, 0)
        dominated = torch.zeros(n, dtype=torch.bool, device=dev)
        for off in adj_offs:
            nb_cnt = shift(ccnt, off)
            better = (nb_cnt > cnt) | ((nb_cnt == cnt)
                                       & (shift(clcg, off) > lcg))
            dominated |= adj[off] & shift(cand, off, fill=False) & better
        cf = torch.where(cand & ~dominated, 1, cf)  # stays int8

        is_c = cf > 0
        infl_c = torch.zeros(n, dtype=torch.bool, device=dev)
        for k, off in enumerate(offsets):
            if off != 0:
                infl_c |= S[k] & shift(is_c, off, fill=False)
        newly_f = (in_graph & (cnt < 1)) | (in_graph & ~is_c & infl_c)
        cf = torch.where(in_graph & is_c, 1, cf)
        cf = torch.where(newly_f, -1, cf)
        settled = in_graph & (cf != 0)
        cnt = torch.where(settled, 0, cnt)
        in_graph = in_graph & (cf == 0)
        it += 1
    return cf
