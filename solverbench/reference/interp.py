"""The benchmark's own strength graph and interpolation weights.

For each level the reference takes from the program only its C / F
split (hypre's PMIS / HMIS draw random measures, and the split is the
program's choice) and, where P_max truncation has to choose among
weights of equal size, which of them the program kept.  Everything else
is worked out here again from the reference's own level matrix:

* strength (par_strength.c, hypre_BoomerAMGCreateS): i depends strongly
  on j != i where a_ij < theta * min(0, min_k a_ik) (a_ii >= 0), or
  a_ij > theta * max(0, max_k a_ik) (a_ii < 0); with max_row_sum < 1 a
  row whose |row sum| exceeds |a_ii| * max_row_sum depends on nothing;
* modified classical interpolation (`-interptype 0`, par_interp.c) and
  extended+i interpolation (`-interptype 6`, par_lr_interp.c), below;
* P_max truncation (hypre_BoomerAMGInterpTruncation): a row keeps its
  P_max largest weights by magnitude, rescaled so that its sum stays.

Interpolation of an F point i: C_i^s and F_i^s are the C and F points i
depends on strongly; the candidates are H_i = C_i^s (classical) or
C_i^s and the strong C points of every k in F_i^s (extended+i).  With
abar_km = a_km where m != k and a_km has the sign opposite to a_kk:

  w_ij = a_ij + sum_{k in F_i^s} a_ik abar_kj / s_ik       (j in H_i)
  s_ik = sum_{m in H_i} abar_km  (+ abar_ki for extended+i)
  d_i  = a_ii + the a_ij of every other j (weak neighbours, and strong
         ones that are neither in H_i nor in F_i^s) + a_ik of each k
         with s_ik = 0 (+ sum_k abar_ki a_ik / s_ik for extended+i)
  P_ij = -w_ij / d_i

Classical counts cf > 0 as C and computes every other row; extended+i
counts cf >= 0 as C, leaves rows marked -3 (isolated F points) empty
and ignores their columns.  A C point interpolates by injection.

Plain torch, in the dtype of the level matrix (float64, or float32 for
the control), on its device, in blocks of rows.  Nothing here comes from
the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

KINDS = ("classical", "ext+i")
# triples (row, strong F neighbour, its entry) a block holds at most
BLOCK_TRIPLES = 1 << 25


@dataclasses.dataclass
class CSR:
    """A square level matrix as flat entry arrays (rows sorted)."""
    crow: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n: int

    @classmethod
    def of(cls, A: torch.Tensor) -> "CSR":
        crow = A.crow_indices().long()
        n = A.shape[0]
        rows = torch.repeat_interleave(torch.arange(n, device=crow.device),
                                       crow[1:] - crow[:-1])
        return cls(crow, rows, A.col_indices().long(), A.values(), n)

    def diagonal(self) -> torch.Tensor:
        d = torch.zeros(self.n, dtype=self.vals.dtype, device=self.vals.device)
        on = self.rows == self.cols
        d[self.rows[on]] = self.vals[on]
        return d


def strength(A: CSR, theta: float, max_row_sum: float) -> torch.Tensor:
    """Per entry of A: whether its row depends strongly on its column."""
    off = A.rows != A.cols
    r, v = A.rows[off], A.vals[off]
    zero = torch.zeros(A.n, dtype=v.dtype, device=v.device)
    rmin = zero.scatter_reduce(0, r, v, "amin", include_self=True)
    rmax = zero.scatter_reduce(0, r, v, "amax", include_self=True)
    neg = A.diagonal() < 0
    strong = torch.zeros_like(off)
    strong[off] = torch.where(neg[r], v > theta * rmax[r], v < theta * rmin[r])
    if max_row_sum < 1.0:
        rowsum = zero.index_add(0, A.rows, A.vals)
        weak = rowsum.abs() > A.diagonal().abs() * max_row_sum
        strong &= ~weak[A.rows]
    return strong


def _expand(starts: torch.Tensor, counts: torch.Tensor):
    """(owner, position) of every slot of the ragged ranges
    [starts[q], starts[q] + counts[q])."""
    owner = torch.repeat_interleave(
        torch.arange(len(counts), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = starts[owner] + torch.arange(len(owner), device=counts.device) \
        - first[owner]
    return owner, pos


def _member(keys: torch.Tensor, q: torch.Tensor):
    """(found, index) of each query in the sorted key array."""
    if keys.numel() == 0:
        return (torch.zeros_like(q, dtype=torch.bool),
                torch.zeros_like(q))
    idx = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return keys[idx] == q, idx


def weights(A: CSR, cf: torch.Tensor, kind: str, theta: float,
            max_row_sum: float):
    """The untruncated interpolation weights of the level's F rows:
    (rows, fine columns, values) sorted by row then column, every
    candidate of H_i listed (a weight that sums to zero included)."""
    if kind not in KINDS:
        raise ValueError(f"interpolation {kind!r}; the reference has {KINDS}")
    ext = kind == "ext+i"
    dev, dt, n = A.vals.device, A.vals.dtype, A.n
    cf = cf.to(dev).long()
    is_c = cf >= 0 if ext else cf > 0
    f_row = cf == -1 if ext else ~is_c
    strong = strength(A, theta, max_row_sum)
    sgn = torch.where(A.diagonal() < 0, -1.0, 1.0).to(dt)

    # strong C entries and strong F (-1) entries, as CSR sub-arrays
    sc = strong & is_c[A.cols]
    sf = strong & (cf[A.cols] == -1)
    sc_cnt = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, A.rows, sc.long())
    sc_crow = torch.cat([sc_cnt.new_zeros(1), torch.cumsum(sc_cnt, 0)])
    sc_cols = A.cols[sc]
    # abar: the entries k, m != k whose sign is opposite to a_kk's
    ab = (A.rows != A.cols) & (sgn[A.rows] * A.vals < 0)
    ab_cnt = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, A.rows, ab.long())
    ab_crow = torch.cat([ab_cnt.new_zeros(1), torch.cumsum(ab_cnt, 0)])
    ab_cols, ab_vals = A.cols[ab], A.vals[ab]

    # F pairs (i, k): k in F_i^s, i an F row
    fp = sf & f_row[A.rows]
    fp_i, fp_k, fp_a = A.rows[fp], A.cols[fp], A.vals[fp]
    # triples a row makes: sum over its F pairs of abar's row length
    # (and, for extended+i, of the strong C entries of k)
    per_row = torch.zeros(n, dtype=torch.long, device=dev).index_add_(
        0, fp_i, ab_cnt[fp_k] + (sc_cnt[fp_k] if ext else 0))
    per_row += A.crow[1:] - A.crow[:-1]
    bounds = _blocks(per_row)

    out_r, out_c, out_v = [], [], []
    for r0, r1 in bounds:
        rr, cc, vv = _block(A, r0, r1, ext, f_row, sc, sf, sc_crow, sc_cols,
                            ab_crow, ab_cols, ab_vals, fp_i, fp_k, fp_a, cf)
        out_r.append(rr)
        out_c.append(cc)
        out_v.append(vv)
    return torch.cat(out_r), torch.cat(out_c), torch.cat(out_v)


def _blocks(per_row: torch.Tensor) -> list:
    """Row ranges whose triples stay under BLOCK_TRIPLES each."""
    n = per_row.numel()
    if n == 0:
        return []
    csum = np.cumsum(per_row.cpu().numpy())
    bounds, r0 = [], 0
    while r0 < n:
        base = int(csum[r0 - 1]) if r0 else 0
        r1 = int(np.searchsorted(csum, base + BLOCK_TRIPLES, side="right"))
        r1 = min(max(r1, r0 + 1), n)
        bounds.append((r0, r1))
        r0 = r1
    return bounds


def _block(A, r0, r1, ext, f_row, sc, sf, sc_crow, sc_cols, ab_crow,
           ab_cols, ab_vals, fp_i, fp_k, fp_a, cf):
    n, dev, dt = A.n, A.vals.device, A.vals.dtype
    e0, e1 = int(A.crow[r0]), int(A.crow[r1])
    rows, cols, vals = A.rows[e0:e1], A.cols[e0:e1], A.vals[e0:e1]
    in_f = f_row[rows]
    # the candidates H_i, as sorted keys i * n + m
    direct = sc[e0:e1] & in_f
    keys = [rows[direct] * n + cols[direct]]
    sel = (fp_i >= r0) & (fp_i < r1)
    pi, pk, pa = fp_i[sel], fp_k[sel], fp_a[sel]
    if ext:
        owner, pos = _expand(sc_crow[pk], sc_crow[pk + 1] - sc_crow[pk])
        keys.append(pi[owner] * n + sc_cols[pos])
    hkeys = torch.unique(torch.cat(keys))
    w = torch.zeros(hkeys.numel(), dtype=dt, device=dev)
    d = torch.zeros(r1 - r0, dtype=dt, device=dev)

    # the direct entries of the block's F rows
    on = rows == cols
    d.index_add_(0, rows[on & in_f] - r0, vals[on & in_f])
    offf = ~on & in_f
    found, at = _member(hkeys, rows * n + cols)
    hit = offf & found
    w.index_add_(0, at[hit], vals[hit])
    lump = offf & ~found & ~(sf[e0:e1])
    if ext:
        lump &= cf[cols] != -3
    d.index_add_(0, rows[lump] - r0, vals[lump])

    # the strong F neighbours: s_ik, then their share
    owner, pos = _expand(ab_crow[pk], ab_crow[pk + 1] - ab_crow[pk])
    ti, tm, ta = pi[owner], ab_cols[pos], ab_vals[pos]
    tfound, tat = _member(hkeys, ti * n + tm)
    to_i = (tm == ti) if ext else torch.zeros_like(tfound)
    s = torch.zeros(pk.numel(), dtype=dt, device=dev)
    s.index_add_(0, owner[tfound | to_i], ta[tfound | to_i])
    zero_s = s == 0
    d.index_add_(0, pi[zero_s] - r0, pa[zero_s])
    dist = torch.where(zero_s, torch.zeros_like(s),
                       pa / torch.where(zero_s, torch.ones_like(s), s))
    share = dist[owner] * ta
    w.index_add_(0, tat[tfound], share[tfound])
    d.index_add_(0, ti[to_i] - r0, share[to_i])

    hi = hkeys // n
    hm = hkeys % n
    dd = d[hi - r0]
    if ext:
        keep = dd != 0
        hi, hm, w, dd = hi[keep], hm[keep], w[keep], dd[keep]
    return hi, hm, -w / dd


@dataclasses.dataclass
class Weights:
    """The untruncated weights of one level (`weights`) and what
    judging a P against them needs."""
    rows: torch.Tensor
    cols: torch.Tensor  # coarse indices
    vals: torch.Tensor
    n: int
    is_c: torch.Tensor
    cmap: torch.Tensor

    @classmethod
    def of(cls, A: CSR, cf, kind: str, theta: float,
           max_row_sum: float) -> "Weights":
        cf_t = torch.as_tensor(cf, device=A.vals.device).long()
        is_c = cf_t >= 0 if kind == "ext+i" else cf_t > 0
        cmap = torch.cumsum(is_c.long(), 0) - 1
        wr, wm, wv = weights(A, cf_t, kind, theta, max_row_sum)
        return cls(wr, cmap[wm], wv, A.n, is_c, cmap)


@dataclasses.dataclass
class Judged:
    """A program's P of one level held against the reference's
    weights, and the reference's own P on the same columns."""
    faults: int  # rows that break the rules
    gap: float  # the largest weight gap, relative to its row's largest
    P: torch.Tensor  # the reference's P (torch sparse CSR)


def judge(W: Weights, P_prog, p_max: int, *, tie: float = 1e-9,
          tiny: float = 1e-12) -> Judged:
    """A program's interpolation P_prog (scipy, n x nc) against the
    weights W worked out here.

    Each F row of P_prog must keep only candidates, at most P_max of
    them, and never leave out a weight larger (beyond `tie`, relative)
    than one it kept; a weight under `tiny` of its row's largest counts
    as zero.  Where ties let it choose, the program's choice of columns
    is taken.  The kept weights must equal the reference's rescaled to
    the row's sum: `gap` is the largest difference, over the row's
    largest weight.  A C row must be injection: one entry, 1, at its
    coarse index.  The reference's P is built from W on the program's
    columns, rescaled the same way, in W's dtype."""
    n, is_c, cmap = W.n, W.is_c, W.cmap
    dev, dt = W.vals.device, W.vals.dtype
    nc = int(is_c.sum())
    wr, wc, wv = W.rows, W.cols, W.vals
    faults = 0
    if tuple(P_prog.shape) != (n, nc):
        # nothing of it can be judged row by row: every row is at fault
        faults += n
        P_prog = sp.csr_matrix((n, nc))
    P_prog = sp.csr_matrix(P_prog)
    lens = torch.as_tensor(np.diff(P_prog.indptr), device=dev).long()
    p_rows = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    p_cols = torch.as_tensor(P_prog.indices, device=dev).long()
    p_vals = torch.as_tensor(P_prog.data, device=dev).to(torch.float64)
    faults += int((~torch.isfinite(p_vals)).sum())

    # C rows: injection
    c_idx = torch.nonzero(is_c).flatten()
    good = lens[c_idx] == 1
    if p_cols.numel():
        at = torch.as_tensor(P_prog.indptr[:-1], device=dev).long()[c_idx]
        at = at.clamp(max=p_cols.numel() - 1)
        good &= (p_cols[at] == cmap[c_idx]) & (p_vals[at] == 1.0)
    faults += int((~good).sum())

    # F rows: the program's entries among the candidates
    fmask = ~is_c[p_rows]
    fr, fc, fv = p_rows[fmask], p_cols[fmask], p_vals[fmask]
    width = max(nc, 1)
    found, pos = _member(wr * width + wc, fr * width + fc)
    bad_row = torch.zeros(n, dtype=torch.bool, device=dev)
    bad_row[fr[~found]] = True
    kept = torch.zeros(wr.numel(), dtype=torch.bool, device=dev)
    kept[pos[found]] = True

    w64 = wv.to(torch.float64)
    aw = w64.abs()
    zero = torch.zeros(n, dtype=torch.float64, device=dev)
    rmax = zero.scatter_reduce(0, wr, aw, "amax", include_self=True)
    big = aw > tiny * rmax[wr]

    def count(m):
        return torch.zeros(n, dtype=torch.long, device=dev).index_add_(
            0, wr[m], torch.ones_like(wr[m]))

    n_big, n_keptbig = count(big), count(big & kept)
    cap = p_max if p_max > 0 else n + 1
    bad_row |= count(kept) > cap
    bad_row |= n_keptbig < torch.clamp(n_big, max=cap)
    inf = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    min_kept = inf.scatter_reduce(0, wr[big & kept], aw[big & kept], "amin",
                                  include_self=True)
    max_left = zero.scatter_reduce(0, wr[big & ~kept], aw[big & ~kept],
                                   "amax", include_self=True)
    bad_row |= max_left > min_kept * (1 + tie)
    faults += int(bad_row[~is_c].sum())

    # the kept weights, rescaled to the row's sum
    def rescaled(v):
        z = torch.zeros(n, dtype=v.dtype, device=dev)
        total, part = z.index_add(0, wr, v), z.index_add(0, wr[kept], v[kept])
        one = torch.ones_like(part)
        scale = torch.where(part != 0, total / torch.where(part == 0, one,
                                                           part), one)
        return v * scale[wr]

    gap = 0.0
    if bool(found.any()):
        expect = rescaled(w64)[pos[found]]
        gap = float(((fv[found] - expect).abs() / rmax[fr[found]]).max())

    kr, kc, kv = wr[kept], wc[kept], rescaled(wv)[kept]
    rr = torch.cat([kr, c_idx])
    cc = torch.cat([kc, cmap[c_idx]])
    vv = torch.cat([kv, torch.ones(c_idx.numel(), dtype=dt, device=dev)])
    P = torch.sparse_coo_tensor(torch.stack([rr, cc]), vv, (n, nc)
                                ).coalesce().to_sparse_csr()
    return Judged(faults=faults, gap=gap, P=P)
