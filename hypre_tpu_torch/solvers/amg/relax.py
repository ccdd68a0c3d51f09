"""Smoothers (port of hypre_tpu/solvers/amg/relax.py).

Reference: parcsr_ls/par_relax.c hypre_BoomerAMGRelax (:109-137 dispatch):
  0   weighted Jacobi (CF variant = relax_points +-1)
  7   Jacobi via matvec
  5   chaotic GS (order-free on a data-parallel machine == Jacobi)
  3/4 hybrid forward/backward SOR-GS     (np=1, 1 thread -> true GS)
  6   hybrid symmetric SSOR-GS
  13/14 L1-GS forward/backward           (np=1, 1 thread -> GS with the
        option-4 l1 norm, which degenerates to |a_ii|, ams.c:569-660)
  18  L1-Jacobi
  16  Chebyshev (par_cheby.c)

The Jacobi family is one fused SpMV launch on the card (ops/forms.py).
Gauss-Seidel follows the JAX package's level-scheduled substitution
(par_relax.c:472-560): the wavefront levels of the triangular dependency
DAG are computed on the host (the native `gs_levels`), and a sweep updates
one wavefront after another, each wavefront's rows at once, which is
sequential GS exactly.  On the card a whole sweep is one launch of the
hand-written kernel (ops/gs_kernel.py); on the CPU it is the JAX step in
torch over the JAX package's padded slabs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ... import native
from ...ops.csr import CSRMatrix
from ...ops.dia import spmv, spmv_jacobi, spmv_resid
from ...ops.gs_kernel import gs_sweep_cuda, gs_sweep_reference

# ---------------------------------------------------------------------------
# Jacobi family
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Level-scheduled Gauss-Seidel
# ---------------------------------------------------------------------------


def _inverse(div: np.ndarray) -> np.ndarray:
    """1 / div, 0 where div is 0 (the JAX package's _pack_gs formula)."""
    return np.where(div != 0, 1.0 / np.where(div == 0, 1, div), 0.0)


@dataclasses.dataclass(frozen=True, eq=False)
class GSMatrix:
    """A level's rows as the sweep kernel reads them, on one device: CSR
    with float64 values and the float64 inverse divisor.  The schedules
    of a level (both directions, and the C / F halves) share one.

    `done` and `ctl` are the sync-free sweep's state (csrc/gs_sweep.cu):
    done[i] holds row i's value as the sweep that last finished it
    published it, beside that sweep's epoch (two 64-bit words); ctl[0]
    is the epoch of the level's last sweep and ctl[1] the arrival count
    of the launch in flight.  The kernel alone writes them, so the
    level's sweeps must run in stream order (they do: one stream)."""

    indptr: torch.Tensor  # int32 [n + 1]
    indices: torch.Tensor  # int32 [nnz]
    data: torch.Tensor  # float64 [nnz]
    dinv: torch.Tensor  # float64 [n]  (1 / divisor, 0 where it is 0)
    done: torch.Tensor  # int64 [n, 2]
    ctl: torch.Tensor  # int32 [2]

    @classmethod
    def from_arrays(cls, indptr, indices, data, dinv, device) -> "GSMatrix":
        """From host arrays (any integer / float dtype), with fresh sweep
        state."""
        dev = torch.device(device)
        n = len(dinv)
        return cls(
            indptr=torch.from_numpy(np.asarray(indptr, np.int32)).to(dev),
            indices=torch.from_numpy(np.asarray(indices, np.int32)).to(dev),
            data=torch.from_numpy(np.asarray(data, np.float64)).to(dev),
            dinv=torch.from_numpy(np.asarray(dinv, np.float64)).to(dev),
            done=torch.zeros((n, 2), dtype=torch.int64, device=dev),
            ctl=torch.zeros(2, dtype=torch.int32, device=dev))

    @classmethod
    def build(cls, A: CSRMatrix, divisor: Optional[np.ndarray],
              device) -> "GSMatrix":
        if A.nnz >= 2**31:
            raise ValueError(f"GS sweep: {A.nnz} entries need 64-bit indices")
        div = divisor if divisor is not None else A.to_scipy().diagonal()
        return cls.from_arrays(A.indptr, A.indices, A.data,
                               _inverse(np.asarray(div)), device)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.indptr, self.indices, self.data, self.dinv,
                             self.done, self.ctl))


@dataclasses.dataclass(eq=False)
class GSSchedule:
    """Wavefront schedule of one sweep direction (or one CF half of it).

    On `mat`'s device: `order` lists the schedule's rows wavefront by
    wavefront, wf_ptr[l]..wf_ptr[l+1] bounding wavefront l; `wave[i]` is
    row i's wavefront (-1 for a row outside the schedule); `hazard[l]`
    is 1 where a row of wavefront l reads another row of it (only a
    nonsymmetric pattern has one), which the wavefront kernel then
    updates in two phases so every row reads the values from before the
    wavefront.  The read rule of a sweep: row i reads u_j new if and
    only if 0 <= wave[j] < wave[i], else as it was before the sweep.
    `slots` is `order` with each wavefront padded by -1 to a multiple of
    SLOT_ALIGN positions, so a warp's pass of the sync-free kernel (a
    power of two of them, at most SLOT_ALIGN, aligned) never holds rows
    of two wavefronts.

    The JAX package's padded slabs (rows [L, W] with the sentinel n,
    acols / adata [L, W, width], dinv [L, W], relax.py:64-78) are packed
    on the host at first use (`host_slabs`); the plain version sweeps
    over them."""

    n: int
    mat: GSMatrix
    order: torch.Tensor  # int32 [rows in the schedule]
    wf_ptr: torch.Tensor  # int32 [L + 1]
    wave: torch.Tensor  # int32 [n]
    slots: torch.Tensor  # int32 [sum of the widths rounded up to SLOT_ALIGN]
    hazard: torch.Tensor  # uint8 [L]
    widths: np.ndarray  # rows of each wavefront (host)
    max_row: int  # entries of the longest row in the schedule
    any_hazard: bool
    # (A, buckets, divisor) for _pack_gs, or the packed slabs themselves
    _pack_args: Optional[tuple] = None
    _slabs: Optional[tuple] = None

    @property
    def num_wavefronts(self) -> int:
        return len(self.widths)

    @property
    def max_width(self) -> int:
        return int(self.widths.max(initial=0))

    @property
    def full(self) -> bool:
        """Whether every row of the level is in the schedule."""
        return self.order.numel() == self.n

    def host_slabs(self) -> tuple:
        """(rows, acols, adata, dinv) as numpy, bitwise the JAX package's
        GSSchedule leaves for the same inputs (packed once)."""
        if self._slabs is None:
            self._slabs = _pack_gs(*self._pack_args)
        return self._slabs

    def slabs(self, device) -> tuple:
        """The slabs as tensors on `device` (rows and acols int64)."""
        rows, acols, adata, dinv = self.host_slabs()
        dev = torch.device(device)
        return (torch.from_numpy(rows.astype(np.int64)).to(dev),
                torch.from_numpy(acols.astype(np.int64)).to(dev),
                torch.from_numpy(adata).to(dev), torch.from_numpy(dinv).to(dev))

    def nbytes(self) -> int:
        """Bytes of this schedule's own tensors on its device (the shared
        GSMatrix not included)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.order, self.wf_ptr, self.wave, self.slots,
                             self.hazard))

    @classmethod
    def from_slabs(cls, rows, acols, adata, dinv, n: int,
                   device) -> "GSSchedule":
        """A schedule from the JAX package's slabs (numpy), e.g. a frozen
        JAX hierarchy carried over by convert.levels_from_numpy.  The
        kernel's CSR keeps each scheduled row's slots that are not
        padding (column 0 with value 0); the plain version sweeps the
        slabs as they are."""
        # writable copies (JAX's arrays are read-only), kept for the
        # plain version
        rows, acols, adata, dinv = (np.array(a) for a in (rows, acols, adata,
                                                          dinv))
        real = rows < n
        order = rows[real].astype(np.int64)
        widths = real.sum(axis=1)
        keep = (acols[real] != 0) | (adata[real] != 0)
        cnt = np.zeros(n, dtype=np.int64)
        cnt[order] = keep.sum(axis=1)
        indptr = np.concatenate([[0], np.cumsum(cnt)])
        # rows in ascending order so the CSR is laid out row by row
        by_row = np.argsort(order, kind="stable")
        indices = acols[real][by_row][keep[by_row]]
        data = adata[real][by_row][keep[by_row]]
        div_inv = np.zeros(n)
        div_inv[order] = dinv[real]
        mat = GSMatrix.from_arrays(indptr, indices, data, div_inv, device)
        sched = _schedule(n, indptr, indices, order, widths, mat)
        sched._slabs = (rows, acols, adata, dinv)
        return sched


# the sync-free kernel's passes: 32 / S rows of a warp (S the lanes a row)
SLOT_ALIGN = 32


def _schedule(n: int, indptr, indices, order, widths, mat,
              pack_args=None) -> GSSchedule:
    """The device schedule of `order` (rows wavefront by wavefront,
    `widths` rows each) over the CSR pattern (indptr, indices), with each
    row's wavefront and the hazard flags."""
    nwf = len(widths)
    wave = np.full(n, -1, dtype=np.int64)
    wave[order] = np.repeat(np.arange(nwf), widths)
    rn = np.diff(indptr)
    r = np.repeat(np.arange(n), rn)
    c = np.asarray(indices, dtype=np.int64)
    same = (wave[r] >= 0) & (r != c) & (wave[c] == wave[r])
    hazard = np.zeros(nwf, dtype=np.uint8)
    hazard[wave[r[same]]] = 1
    # each wavefront from a multiple of SLOT_ALIGN on, pads -1
    padded = -(-np.asarray(widths, np.int64) // SLOT_ALIGN) * SLOT_ALIGN
    slots = np.full(int(padded.sum()), -1, dtype=np.int32)
    if len(order):
        l_of = np.repeat(np.arange(nwf), widths)
        start = np.concatenate([[0], np.cumsum(padded)[:-1]])
        first = np.concatenate([[0], np.cumsum(widths)[:-1]])
        slots[start[l_of] + np.arange(len(order)) - first[l_of]] = order
    dev = mat.indptr.device
    return GSSchedule(
        n=n, mat=mat,
        order=torch.from_numpy(np.asarray(order, np.int32)).to(dev),
        wf_ptr=torch.from_numpy(
            np.concatenate([[0], np.cumsum(widths)]).astype(np.int32)).to(dev),
        wave=torch.from_numpy(wave.astype(np.int32)).to(dev),
        slots=torch.from_numpy(slots).to(dev),
        hazard=torch.from_numpy(hazard).to(dev),
        widths=np.asarray(widths, dtype=np.int64),
        max_row=int(rn[order].max(initial=0)) if len(order) else 0,
        any_hazard=bool(hazard.any()), _pack_args=pack_args)


def build_gs_schedule(
    A: CSRMatrix,
    forward: bool = True,
    divisor: np.ndarray | None = None,
    mask: np.ndarray | None = None,
    *,
    device,
    mat: GSMatrix | None = None,
) -> GSSchedule:
    """Host: compute wavefront levels of the (lower/upper) triangular
    dependency DAG (the par_relax.c:472-560 analog) and lay the
    schedule out on `device`.  With `mask` (CF-ordered GS, par_cycle.c:398
    relax_order sweeps), only mask rows are updated and only mask-row
    dependencies order the wavefronts — non-mask values are constants for
    the sweep.  `mat` (the level's GSMatrix, built with the same divisor)
    is shared when given."""
    n = A.shape[0]
    indptr, indices = A.indptr, A.indices

    if mask is None:
        level = native.gs_levels(indptr, indices, n, forward)
        nlev = int(level.max()) + 1 if n else 1
    else:
        inmask = np.asarray(mask, bool)
        level = np.full(n, -1, dtype=np.int64)
        order = range(n) if forward else range(n - 1, -1, -1)
        for i in order:
            if not inmask[i]:
                continue
            cols = indices[indptr[i]: indptr[i + 1]]
            deps = cols[cols < i] if forward else cols[cols > i]
            deps = deps[inmask[deps]]
            lv = level[deps]
            lv = lv[lv >= 0]
            level[i] = lv.max() + 1 if lv.size else 0
        nlev = int(level.max()) + 1 if (level >= 0).any() else 1
    buckets = [np.flatnonzero(level == l) for l in range(nlev)]
    if mat is None:
        mat = GSMatrix.build(A, divisor, device)
    order = (np.concatenate(buckets) if buckets
             else np.zeros(0, dtype=np.int64))
    return _schedule(n, np.asarray(indptr, np.int64), indices, order,
                     np.array([len(b) for b in buckets], dtype=np.int64),
                     mat, pack_args=(A, buckets, divisor))


def _pack_gs(A: CSRMatrix, buckets, divisor):
    """The JAX package's padded per-wavefront ELL slabs, on the host:
    (rows, acols, adata, dinv) with the data in A's own dtype."""
    n = A.shape[0]
    nlev = len(buckets)
    W = max((len(b) for b in buckets), default=1) or 1
    # host row-major ELL, width the longest row (at least 1)
    rn = np.diff(A.indptr)
    width = max(int(rn.max(initial=0)), 1)
    cols_h = np.zeros((max(n, 1), width), dtype=np.int32)
    data_h = np.zeros((max(n, 1), width), dtype=np.asarray(A.data).dtype)
    if A.nnz:
        r = np.repeat(np.arange(n), rn)
        k = np.arange(A.nnz) - np.repeat(A.indptr[:-1], rn)
        cols_h[r, k] = A.indices
        data_h[r, k] = A.data
    div = divisor if divisor is not None else A.to_scipy().diagonal()

    rows = np.full((nlev, W), n, dtype=np.int32)
    acols = np.zeros((nlev, W, width), dtype=np.int32)
    adata = np.zeros((nlev, W, width), dtype=data_h.dtype)
    dinv = np.zeros((nlev, W), dtype=data_h.dtype)
    for l, b in enumerate(buckets):
        rows[l, : len(b)] = b
        acols[l, : len(b)] = cols_h[b]
        adata[l, : len(b)] = data_h[b]
        dinv[l, : len(b)] = _inverse(div[b])
    return rows, acols, adata, dinv


def gauss_seidel(sched: GSSchedule, u, f, weight=1.0, omega=1.0, v=None):
    """One sweep in the schedule's direction; exact sequential-GS math.

    `omega` is hypre's outer SOR weight (par_relax.c:1277
    ``prod = 1 - relax_weight*omega`` recurrence).  Expanding the
    reference update
    ``u_i = prod*u_i + w*(omega*f_i + res0 + (1-omega)*res2)/a_ii``
    with full row sums S (diagonal included), the a_ii terms collapse
    to ``u_i += w*((1-omega)*(u_i - v_i)
    + dinv_i*(omega*f_i - S_cur + (1-omega)*S_pre))`` — with v == u
    (a single sweep) the first term vanishes and omega == 1 recovers
    the plain weighted sweep.  `v` is the pre-CALL iterate defining
    S_pre: hypre copies Vtemp once per Relax call (par_relax.c:3148), so
    SSOR's backward half reuses the forward half's v; defaults to u (a
    plain single sweep).

    A CUDA u takes the kernel (one launch) or raises; a CPU u the plain
    version over the slabs."""
    if u.device.type == "cuda":
        return gs_sweep_cuda(sched, u, f, weight, omega, v)
    if u.device.type == "cpu":
        return gs_sweep_reference(sched.slabs(u.device), sched.n, u, f,
                                  weight, omega, v)
    raise ValueError(f"gauss_seidel: no path for device {u.device}")


# ---------------------------------------------------------------------------
# Chebyshev (relax 16)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChebyData:
    coefs: tuple  # [order] float64 coefficients, lowest degree first
    dsqrtinv: torch.Tensor  # float64 D^{-1/2} (scaled variant)
    order: int


def cheby_setup(
    A: CSRMatrix,
    order: int = 2,
    ratio: float = 0.3,
    max_eig: float | None = None,
    min_eig: float | None = None,
    eig_est_iters: int = 10,
    *,
    device,
) -> ChebyData:
    """Coefficients of the scaled Chebyshev smoother, matching
    hypre_ParCSRRelax_Cheby_Setup (par_cheby.c):
      upper = 1.1 * max_eig;  lower = (upper - min_eig)*fraction + min_eig
      theta = (upper+lower)/2, delta = (upper-lower)/2
      standard-variant monomial coefficients for cheby_order = order-1
    Eigen bounds from the exact hypre_ParCSRMaxEigEstimateCG replica
    (max_eig_estimate_cg below; cheby_eig_est=10, cheby_scale=1
    defaults — par_amg_setup.c's call for relax 16).
    """
    diag = A.to_scipy().diagonal()
    dsqrtinv = 1.0 / np.sqrt(np.abs(diag))
    if max_eig is None or min_eig is None:
        hi, lo = max_eig_estimate_cg(
            A, scale=True, max_iter=max(eig_est_iters, 3)
        )
        max_eig = hi if max_eig is None else max_eig
        min_eig = max(lo, 0.0) if min_eig is None else min_eig

    upper = max_eig * 1.1
    lower = (upper - min_eig) * ratio + min_eig
    theta = (upper + lower) / 2
    delta = (upper - lower) / 2

    order = min(max(order, 1), 4)
    coefs = _cheby_std_coefs(order, theta, delta)
    return ChebyData(
        coefs=tuple(float(c) for c in coefs),
        dsqrtinv=torch.from_numpy(dsqrtinv.astype(np.float64)).to(device),
        order=order,
    )


def max_eig_estimate_cg(A: CSRMatrix, scale: bool = True,
                        max_iter: int = 10):
    """hypre_ParCSRMaxEigEstimateCG (par_relax_more.c:115-390), exact
    arithmetic replica: r = SetRandomValues(seed 1) via the bit-exact
    hypre LCG (utils/lcg.py), the unpreconditioned CG recurrence
    (s = C*r with C = I — the reference's own TODO leaves diagonal
    preconditioning unimplemented), the tridiag/trioffd fill with
    beta-rescaling, and the tridiagonal eigensolve (LINPACK cgtql1
    there, LAPACK here — same matrix, agreement to roundoff).
    scale: estimate on D^{-1/2} A D^{-1/2} (relax 16 / cheby_scale=1).
    Returns (max_eig, min_eig).  Host numpy, as in the JAX package."""
    from ...utils.lcg import lcg_fill

    M = sp.csr_matrix(A.to_scipy())
    n = A.shape[0]
    max_iter = min(max_iter, n)
    r = 2.0 * lcg_fill(1, n) - 1.0
    ds = 1.0 / np.sqrt(M.diagonal()) if scale else np.ones(n)
    tridiag = np.zeros(max_iter + 1)
    trioffd = np.zeros(max_iter + 1)
    gamma = 0.0
    p = np.zeros(n)
    for i in range(max_iter):
        s = r.copy()
        gamma_old = gamma
        gamma = float(r @ s)
        if i == 0:
            beta = 1.0
            p = s.copy()
        else:
            beta = gamma / gamma_old
            p = s + beta * p
        if scale:
            s = ds * (M @ (ds * p))
        else:
            s = M @ p
        sdotp = float(s @ p)
        alpha = gamma / sdotp
        alphainv = 1.0 / alpha
        tridiag[i + 1] = alphainv
        tridiag[i] = tridiag[i] * beta + alphainv
        trioffd[i + 1] = alphainv
        trioffd[i] *= np.sqrt(beta)
        r = r - alpha * s
    T = np.diag(tridiag[:max_iter])
    for j in range(max_iter - 1):
        T[j, j + 1] = T[j + 1, j] = trioffd[j + 1]
    ev = np.linalg.eigvalsh(T)
    return float(ev[-1]), float(ev[0])


def _cheby_std_coefs(order, theta, delta):
    """hypre's standard-variant monomial coefficients (par_cheby.c,
    cheby_order = order-1 cases 0..3, copied formulas 1:1)."""
    th, de = theta, delta
    co = order - 1
    if co == 0:
        return np.array([1.0 / th])
    if co == 1:
        den = de * de - 2 * th * th
        return np.array([-4 * th / den, 2 / den])
    if co == 2:
        den = 3 * de * de * th - 4 * th**3
        return np.array(
            [(3 * de * de - 12 * th * th) / den, 12 * th / den, -4 / den]
        )
    den = de**4 - 8 * de * de * th * th + 8 * th**4
    return np.array([
        (32 * th**3 - 16 * de * de * th) / den,
        (8 * de * de - 48 * th * th) / den,
        32 * th / den,
        -8 / den,
    ])


def chebyshev(A, cd: ChebyData, u, f):
    """u += D^{-1/2} p(As) D^{-1/2} r with As = D^{-1/2} A D^{-1/2}.

    The polynomial is evaluated in float64, as the JAX package's float64
    dsqrtinv and coefficients promote it; the matvecs take their operand
    in u's dtype (the kernels' vector type) and the result is u's dtype.
    With float64 vectors that is the JAX package's arithmetic exactly."""
    ds = cd.dsqrtinv
    r = ds * spmv_resid(A, u, f)
    # Horner on the scaled operator
    acc = cd.coefs[cd.order - 1] * r
    for k in range(cd.order - 2, -1, -1):
        acc = cd.coefs[k] * r + ds * spmv(A, (ds * acc).to(u.dtype))
    return (u + ds * acc).to(u.dtype)
