"""Distributed AMG setup for GENERAL sharded CSR operators (port of
hypre_tpu/parallel/dist_csr_setup.py), the general-matrix counterpart
of dist_setup.py.  The reference's setup is MPI-parallel for any
ParCSR matrix:

  * PMIS exchanges measures / CF markers through CommPkg halo jobs
    (parcsr_ls/par_coarsen.c:2741), the S^T influence through the
    transposed pattern (parcsr_mv/communicationT.c);
  * interpolation fetches the remote rows its distance-2 terms need
    (hypre_ParCSRMatrixExtractBExt, parcsr_mv/par_csr_matop.c:1655);
  * the Galerkin product is hypre_ParMatmul (par_csr_matop.c:277):
    local rows x (local + fetched) rows, then the contributions to
    other shards' coarse rows shipped to their owners.

Here:
  * `dist_pmis` runs strength, measures and the iterated independent
    set on the shards' devices over the ParCSR's host ELL arrays:
    forward ghost values ride `halo.exchange`, S^T contributions
    `halo.reverse_exchange`.  The JAX package's `lax.while_loop` is a
    host loop that reads one global `any` an iteration.  Every compare
    uses the host path's f64 measures (count + Park-Miller rand) in its
    order, so the CF split is bitwise `coarsen.pmis_coarsen` on the
    assembled matrix.
  * `dist_classical_interp` / `dist_rap` run per shard on the host over
    the shard's own rows plus the ghost rows its halo plan names (the
    BExt fetch list); no step forms the global matrix.  P's rows are
    bitwise the serial interpolation's; the coarse operator equals the
    serial one to rounding (the contribution-sum order differs by
    shard, as MPI layouts differ in the reference).
  * `dist_csr_hierarchy` iterates level to level (0 -> 1 -> 2 ...).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..solvers.amg.coarsen import C_PT, F_PT, SF_PT, _PMIS_SEED
from ..utils.errors import arg_error
from ..utils.lcg import lcg_fill
from .halo import exchange, reverse_exchange
from .par_csr import ParCSR
from .partition import block_partition

_MAX_ROUNDS = 500


# ----------------------------------------------------------------------
# sharded strength + PMIS
# ----------------------------------------------------------------------

def _strength_slots(dv, dc, ov, oc, per, gw, theta, max_row_sum):
    """Per-slot strong masks (sd over the diag ELL, so over the offd
    ELL): par_strength.c hypre_BoomerAMGCreateS over the diag / offd
    split.  ELL pad slots hold 0.0 and never pass the strict test
    (row_scale starts at 0.0 as in the reference)."""
    rows = torch.arange(per, dtype=dc.dtype, device=dc.device)
    is_diag_slot = dc == rows[:, None]
    diag = torch.where(is_diag_slot, dv, 0.0).sum(dim=1)
    neg = diag < 0

    offv = torch.where(is_diag_slot, 0.0, dv)
    row_max = torch.maximum(offv.amax(dim=1), ov.amax(dim=1))
    row_max = torch.clamp_min(row_max, 0.0)  # hypre inits row_scale to 0.0
    row_min = torch.minimum(offv.amin(dim=1), ov.amin(dim=1))
    row_min = torch.clamp_max(row_min, 0.0)
    thresh = theta * torch.where(neg, row_max, row_min)

    sd = torch.where(neg[:, None], dv > thresh[:, None], dv < thresh[:, None])
    sd = sd & ~is_diag_slot
    so = torch.where(neg[:, None], ov > thresh[:, None], ov < thresh[:, None])
    so = so & (oc < gw)  # the pad-sink slots are no entries

    if max_row_sum < 1.0:
        rs = dv.sum(dim=1) + ov.sum(dim=1)
        weak_row = rs.abs() > diag.abs() * max_row_sum
        sd = sd & ~weak_row[:, None]
        so = so & ~weak_row[:, None]
    return sd, so


def _scatter_max(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros(n).at[idx].max(vals) over flattened [rows, slots]."""
    out = vals.new_zeros(n)
    return out.scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1), "amax")


def dist_pmis(A: ParCSR, seed: int = _PMIS_SEED, theta: float = 0.25,
              max_row_sum: float = 0.9) -> np.ndarray:
    """Sharded PMIS over a general ParCSR: the GLOBAL CF marker (int64,
    C_PT / F_PT / SF_PT), bitwise coarsen.pmis_coarsen(strength_matrix(A)).

    Forward candidate measures ride the halo plan (par_coarsen.c:2741's
    CommPkg jobs); the S^T direction rides reverse_exchange: each row
    scatter-maxes its candidate measure onto the columns it strongly
    depends on, local ones directly, remote ones through the transposed
    plan (communicationT.c)."""
    plan = A.plan
    S = A.mesh.shape[A.axis]
    per = A.part.rows_per_shard
    gw = plan.ghost_width
    theta = float(theta)
    max_row_sum = float(max_row_sum)
    f64 = torch.float64
    sh = []  # per shard: (dc, dv, oc, ov, sd, so) on its device
    for s, dev in enumerate(A.mesh.devices):
        dc = torch.from_numpy(A.diag_cols[s].astype(np.int64)).to(dev)
        oc = torch.from_numpy(A.offd_cols[s].astype(np.int64)).to(dev)
        dv = torch.from_numpy(A.diag_data[s].astype(np.float64)).to(dev)
        ov = torch.from_numpy(A.offd_data[s].astype(np.float64)).to(dev)
        sd, so = _strength_slots(dv, dc, ov, oc, per, gw, theta, max_row_sum)
        sh.append((dc, dv, oc, ov, sd, so))

    # S^T column counts: local scatter + the transposed-comm combine
    gcnt = [torch.zeros(gw + 1, dtype=torch.int32, device=so.device)
            .index_add_(0, oc.reshape(-1), so.reshape(-1).to(torch.int32))
            for dc, dv, oc, ov, sd, so in sh]
    remote = reverse_exchange(plan, gcnt, per, "add")
    cf, in_graph, m = [], [], []
    for s, (dc, dv, oc, ov, sd, so) in enumerate(sh):
        cnt = torch.zeros(per, dtype=torch.int32, device=dc.device).index_add_(
            0, dc.reshape(-1), sd.reshape(-1).to(torch.int32)) + remote[s]
        # per-shard Park-Miller draws for global rows [s*per, (s+1)*per)
        # (par_indepset.c:33-62: rank p skips first_row draws)
        rand = torch.from_numpy(lcg_fill(seed, per, skip=s * per)).to(dc.device)
        measure = cnt.to(f64) + rand
        isolated = ~(sd.any(dim=1) | so.any(dim=1))
        cf.append(torch.where(isolated, SF_PT, 0).to(torch.int32))
        in_graph.append(~isolated)
        m.append(torch.where(isolated, 0.0, measure))

    it = 0
    while it < _MAX_ROUNDS and any(bool(g.any()) for g in in_graph):
        cand = [g & (ms > 1.0) for g, ms in zip(in_graph, m)]
        mc = [torch.where(c, ms, 0.0) for c, ms in zip(cand, m)]
        ghost_mc = exchange(plan, mc)
        stg, madj = [], []
        for s, (dc, dv, oc, ov, sd, so) in enumerate(sh):
            # dominance along S rows (i depends on j)
            ma = torch.maximum(
                torch.where(sd, mc[s][dc], 0.0).amax(dim=1),
                torch.where(so, ghost_mc[s][oc], 0.0).amax(dim=1))
            # dominance along S^T (j depends on i): scatter-max back
            mrow = mc[s][:, None]
            ma = torch.maximum(
                ma, _scatter_max(per, dc, torch.where(sd, mrow, 0.0)))
            stg.append(_scatter_max(gw + 1, oc, torch.where(so, mrow, 0.0)))
            madj.append(ma)
        back = reverse_exchange(plan, stg, per, "max")
        for s in range(S):
            in_is = cand[s] & ~(torch.maximum(madj[s], back[s]) > m[s])
            cf[s] = torch.where(in_is, C_PT, cf[s]).to(torch.int32)
        is_c = [c > 0 for c in cf]
        ghost_c = exchange(plan, [c.to(torch.int32) for c in is_c])
        for s, (dc, dv, oc, ov, sd, so) in enumerate(sh):
            infl_c = ((sd & is_c[s][dc]).any(dim=1)
                      | (so & (ghost_c[s][oc] > 0)).any(dim=1))
            g = in_graph[s]
            newly_f = (g & (m[s] < 1.0)) | (g & ~is_c[s] & infl_c)
            c = torch.where(g & is_c[s], C_PT, cf[s])
            c = torch.where(newly_f, F_PT, c).to(torch.int32)
            cf[s] = c
            m[s] = torch.where(g & (c != 0), 0.0, m[s])
            in_graph[s] = g & (c == 0)
        it += 1
    return torch.cat([c.cpu() for c in cf])[: A.n].numpy().astype(np.int64)


# ----------------------------------------------------------------------
# per-shard host phases (BExt-structured: local rows + plan ghost rows)
# ----------------------------------------------------------------------

def _fetch_rows(blocks, part, gids, shape):
    """Rows `gids` gathered from their owners' blocks (batched per
    owner: the ExtractBExt fetch, par_csr_matop.c:1655), placed at
    their global row positions in a `shape` CSR."""
    gids = np.asarray(gids, dtype=np.int64)
    rr, cc, vv = [], [], []
    if gids.size:
        owners = part.owner(gids)
        for o in np.unique(owners):
            sel = gids[owners == o]
            sub = blocks[int(o)][sel - int(o) * part.rows_per_shard].tocoo()
            rr.append(sel[sub.row])
            cc.append(sub.col.astype(np.int64))
            vv.append(sub.data)
    rows = np.concatenate(rr) if rr else np.empty(0, np.int64)
    cols = np.concatenate(cc) if cc else np.empty(0, np.int64)
    vals = np.concatenate(vv) if vv else np.empty(0)
    M = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    M.sort_indices()
    return M


def _bounds(part, s: int, n: int):
    lo = min(s * part.rows_per_shard, n)
    return lo, min(lo + part.rows_per_shard, n)


def _sub_rows(A: ParCSR, s: int) -> sp.csr_matrix:
    """The n x n matrix holding only the rows shard s can see: its own
    block and the ghost rows its col_map names (the ExtractBExt fetch
    set); every other row empty."""
    lo, hi = _bounds(A.part, s, A.n)
    gids = np.concatenate([np.arange(lo, hi, dtype=np.int64),
                           np.asarray(A.col_maps[s], dtype=np.int64)])
    return _fetch_rows(A.host_blocks, A.part, gids, (A.n, A.n))


def dist_classical_interp(A: ParCSR, cf: np.ndarray):
    """Per-shard classical interpolation (interp_type 0,
    par_interp.c hypre_BoomerAMGBuildInterp): each shard computes the P
    rows of its fine rows from its local and fetched ghost rows.
    Returns (P: ParCSR n x nc, blocks: the per-shard scipy rows over
    global coarse columns); bitwise interp.classical_interp on the
    assembled matrix (the same per-row arithmetic on the same inputs)."""
    from ..solvers.amg.interp import classical_interp
    from ..solvers.amg.strength import strength_matrix

    S = A.part.n_shards
    nc = int((cf > 0).sum())
    blocks = []
    for s in range(S):
        lo, hi = _bounds(A.part, s, A.n)
        Asub = _sub_rows(A, s)
        Psub = classical_interp(Asub, strength_matrix(Asub), cf)
        blocks.append(Psub[lo:hi].tocsr())
    Ppar = ParCSR.from_row_blocks(blocks, (A.n, nc), mesh=A.mesh, axis=A.axis,
                                  col_part=block_partition(nc, S))
    return Ppar, blocks


def _shard_rows_global(A: ParCSR, s: int) -> sp.csr_matrix:
    """Shard s's own rows placed at their global positions (n x n)."""
    lo, hi = _bounds(A.part, s, A.n)
    blk = A.host_blocks[s][: hi - lo].tocoo()
    return sp.csr_matrix((blk.data, (blk.row + lo, blk.col)),
                         shape=(A.n, A.n)).tocsr()


def _sum_blocks(per_target, part, n_rows: int, n_cols: int) -> list:
    """Each owner t's sum of the contributions to its rows."""
    blocks = []
    for t, parts in enumerate(per_target):
        lo, hi = _bounds(part, t, n_rows)
        acc = sp.csr_matrix((hi - lo, n_cols))
        for blk in parts:
            acc = acc + blk
        acc.sort_indices()
        blocks.append(acc.tocsr())
    return blocks


def dist_rap(A: ParCSR, P_blocks, nc: int) -> ParCSR:
    """The distributed Galerkin product A1 = P^T A P (hypre_ParMatmul +
    the triple product, par_csr_matop.c:277 / par_csr_triplemat.c):

      per shard s:  AP_s = A_rows(s) @ P_(local + ghost rows)
                    C_s  = P_rows(s)^T @ AP_s      (contributions)
      owner t sums the C_s rows of its coarse block (the
      transposed-comm add-combine, communicationT.c).

    Returns the coarse ParCSR over the uniform coarse partition; the
    serial galerkin_rap's to rounding."""
    S = A.part.n_shards
    n = A.n
    cpart = block_partition(nc, S)
    per_target = [[] for _ in range(S)]
    for s in range(S):
        lo, hi = _bounds(A.part, s, n)
        gids = np.concatenate([np.arange(lo, hi, dtype=np.int64),
                               np.asarray(A.col_maps[s], dtype=np.int64)])
        Pvis = _fetch_rows(P_blocks, A.part, gids, (n, nc))
        AP = (_shard_rows_global(A, s) @ Pvis).tocsr()  # rows [lo, hi)
        C = (P_blocks[s].T @ AP[lo:hi]).tocsr()  # nc x nc contribution
        for t in range(S):
            clo, chi = _bounds(cpart, t, nc)
            blk = C[clo:chi]
            if blk.nnz:
                per_target[t].append(blk)
    return ParCSR.from_row_blocks(_sum_blocks(per_target, cpart, nc, nc),
                                  (nc, nc), mesh=A.mesh, axis=A.axis,
                                  col_part=cpart)


# ----------------------------------------------------------------------
# level driver
# ----------------------------------------------------------------------

def dist_csr_setup(A: ParCSR, *, seed: int = _PMIS_SEED, theta: float = 0.25,
                   max_row_sum: float = 0.9):
    """One setup level: sharded PMIS -> per-shard classical interp ->
    distributed RAP.  Returns (cf, P: ParCSR, A1: ParCSR)."""
    cf = dist_pmis(A, seed=seed, theta=theta, max_row_sum=max_row_sum)
    Ppar, P_blocks = dist_classical_interp(A, cf)
    A1 = dist_rap(A, P_blocks, int((cf > 0).sum()))
    return cf, Ppar, A1


def dist_csr_hierarchy(A: ParCSR, *, max_levels: int = 3, min_coarse: int = 32,
                       seed: int = _PMIS_SEED, theta: float = 0.25,
                       max_row_sum: float = 0.9):
    """dist_csr_setup down the hierarchy (the par_amg_setup.c:27 loop),
    every transition sharded.  Returns (levels, Ps, cfs), levels[0] A."""
    levels, Ps, cfs = [A], [], []
    cur = A
    while len(levels) < max_levels and cur.n > min_coarse:
        cf, Ppar, A1 = dist_csr_setup(cur, seed=seed, theta=theta,
                                      max_row_sum=max_row_sum)
        nc = int((cf > 0).sum())
        if nc == 0 or nc >= cur.n:
            break
        cfs.append(cf)
        Ps.append(Ppar)
        levels.append(A1)
        cur = A1
    return levels, Ps, cfs


# ----------------------------------------------------------------------
# standalone distributed matrix products (parcsr_mv analogs)
# ----------------------------------------------------------------------

def par_matmul(A: ParCSR, B: ParCSR) -> ParCSR:
    """C = A @ B (hypre_ParMatmul, par_csr_matop.c:277): per shard, A's
    local rows times B's visible rows, its own block and the remote rows
    A's offd column map names, fetched per owner.  C keeps A's row
    partition and B's column partition."""
    if A.m != B.n:
        raise arg_error(f"shape mismatch: {A.m} vs {B.n}")
    blocks = []
    for s in range(A.part.n_shards):
        lo, hi = _bounds(A.part, s, A.n)
        blo, bhi = _bounds(B.part, s, B.n)
        gids = np.unique(np.concatenate(
            [np.arange(blo, bhi, dtype=np.int64),
             np.asarray(A.col_maps[s], dtype=np.int64)]))
        gids = gids[gids < B.n]
        Bvis = _fetch_rows(B.host_blocks, B.part, gids, (A.m, B.m))
        Cs = (A.host_blocks[s][: hi - lo] @ Bvis).tocsr()
        Cs.sort_indices()
        blocks.append(Cs)
    return ParCSR.from_row_blocks(blocks, (A.n, B.m), mesh=A.mesh,
                                  axis=A.axis, col_part=B.col_part)


def par_transpose(A: ParCSR) -> ParCSR:
    """C = A^T (hypre_ParCSRMatrixTranspose, par_csr_matop.c:1700): each
    shard transposes its row block and ships the rows to their owners
    under A's COLUMN partition, which sum them (communicationT.c)."""
    S = A.part.n_shards
    tpart = A.col_part
    tn, tm = A.m, A.n
    per_target = [[] for _ in range(S)]
    for s in range(S):
        lo, hi = _bounds(A.part, s, A.n)
        blk = A.host_blocks[s][: hi - lo].tocoo()
        rows_t = blk.col.astype(np.int64)
        cols_t = blk.row.astype(np.int64) + lo
        owners = tpart.owner(rows_t)
        for t in np.unique(owners):
            sel = owners == t
            tlo, thi = _bounds(tpart, int(t), tn)
            per_target[int(t)].append(sp.csr_matrix(
                (blk.data[sel], (rows_t[sel] - tlo, cols_t[sel])),
                shape=(thi - tlo, tm)))
    return ParCSR.from_row_blocks(_sum_blocks(per_target, tpart, tn, tm),
                                  (tn, tm), mesh=A.mesh, axis=A.axis,
                                  col_part=A.part)
