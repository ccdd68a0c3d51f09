"""The read rule of the sync-free Gauss-Seidel sweep, on the CPU.

The card's sync-free kernel (csrc/gs_sweep.cu) lets each row start as
soon as the rows it reads new are final: row i reads u_j new if and only
if 0 <= wave[j] < wave[i], else the value from before the sweep.  Here a
plain torch version of that rule sweeps the rows ONE AT A TIME, in a
random order that respects the dependencies (a random topological order
of "i reads j new"), reading from (u, out) by the rule.  Whatever the
order, it gives the bits of `gs_sweep_reference` (the JAX step over the
padded slabs, the CPU path of `gauss_seidel`): bitwise, in f64 and f32,
because each row's sum is the same torch reduction over the row's slab
slots in the slab order.  Against the JAX package's `gauss_seidel` (XLA
sums the slots in its own order) within 1e-14 relative to max |u|.  So
the rule, not the timing, fixes the result.  Also: the device layout's
`wave` agrees with `order` / `wf_ptr`; an order that breaks a dependency
gives other values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.ops import CSRMatrix as JaxCSR
from hypre_tpu.solvers.amg import relax as jrelax
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops import CSRMatrix
from hypre_tpu_torch.ops.gs_kernel import gs_sweep_cuda, gs_sweep_reference
from hypre_tpu_torch.solvers.amg.relax import build_gs_schedule
from torch_threads import one_thread  # noqa: F401

W, OMEGA = 0.9, 0.8


def _matrix(kind):
    """scipy CSR: the 7-point Laplacian at 10^3 or 24^3, or a random
    nonsymmetric matrix whose wavefronts hold rows that read
    same-wavefront neighbours (hazard wavefronts)."""
    if kind.startswith("7pt"):
        nx = int(kind[3:])
        return laplacian_7pt(nx, nx, nx).to_scipy().tocsr()
    rng = np.random.default_rng(11)
    n = 600
    B = sp.random(n, n, 4.0 / n, random_state=rng, format="csr")
    M = (B + sp.diags(8.0 + rng.random(n))).tocsr()
    M.sort_indices()
    return M


def _mask(n, half):
    """The C (True) or F (False) half of a random 30% C split."""
    c = np.random.default_rng(8).random(n) < 0.3
    return c if half == "C" else ~c


def _dependencies(sched, M):
    """For each scheduled row, the rows it reads new by the rule."""
    wave = sched.wave.numpy()
    deps = {}
    for i in np.flatnonzero(wave >= 0):
        cols = M.indices[M.indptr[i]:M.indptr[i + 1]]
        wc = wave[cols]
        deps[int(i)] = [int(c) for c in cols[(wc >= 0) & (wc < wave[i])]]
    return deps


def _random_order(deps, seed):
    """A uniformly drawn ready row at each step: a random topological
    order of the rows by their dependencies."""
    rng = np.random.default_rng(seed)
    users = {i: [] for i in deps}
    left = {i: len(d) for i, d in deps.items()}
    for i, d in deps.items():
        for j in d:
            users[j].append(i)
    ready = [i for i, k in left.items() if k == 0]
    order = []
    while ready:
        k = int(rng.integers(len(ready)))
        i = ready[k]
        ready[k] = ready[-1]
        ready.pop()
        order.append(i)
        for j in users[i]:
            left[j] -= 1
            if left[j] == 0:
                ready.append(j)
    assert len(order) == len(deps)
    return order


def rule_sweep(sched, u, f, weight=1.0, omega=1.0, v=None, order=()):
    """One sweep by the read rule, rows one at a time in `order`: row i
    sums its slab slots over out[j] where 0 <= wave[j] < wave[i] and u[j]
    elsewhere, with the reference's operations on a one-row slab."""
    rows, acols, adata, dinv = sched.host_slabs()
    n = sched.n
    slot = {int(r): (l, k) for (l, k), r in np.ndenumerate(rows) if r < n}
    acols = torch.from_numpy(acols.astype(np.int64))
    adata, dinv = torch.from_numpy(adata), torch.from_numpy(dinv)
    wave = sched.wave.long()
    plain = float(omega) == 1.0
    vv = u if v is None else v
    out = u.clone()
    for i in order:
        l, k = slot[i]
        c, a, d = acols[l, k:k + 1], adata[l, k:k + 1], dinv[l, k:k + 1]
        wc = wave[c]
        x = torch.where((wc >= 0) & (wc < wave[i]), out[c], u[c])
        if plain:
            r = f[i:i + 1] - torch.sum(a * x, dim=-1)
            upd = (weight * d * r).to(u.dtype)
        else:
            s_cur = torch.sum(a * x, dim=-1)
            s_pre = torch.sum(a * vv[c], dim=-1)
            r = omega * f[i:i + 1] - s_cur + (1.0 - omega) * s_pre
            full = weight * ((1.0 - omega) * (u[i:i + 1] - vv[i:i + 1])
                             + d * r)
            upd = torch.where(d != 0, full, 0.0).to(u.dtype)
        out[i:i + 1] = u[i:i + 1] + upd
    return out


@pytest.mark.parametrize("kind", ["7pt10", "7pt24", "nonsym"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("half", [None, "C", "F"])
def test_wave_agrees_with_order_and_wf_ptr(kind, forward, half):
    """wave[order[p]] is p's wavefront by wf_ptr, every scheduled row once;
    -1 exactly outside the schedule (the other half of a masked pair)."""
    M = _matrix(kind)
    n = M.shape[0]
    mask = None if half is None else _mask(n, half)
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward, mask=mask,
                              device="cpu")
    order, ptr = sched.order.numpy(), sched.wf_ptr.numpy()
    wave = sched.wave.numpy()
    assert sched.wave.dtype == torch.int32 and wave.shape == (n,)
    want = np.full(n, -1)
    for l in range(sched.num_wavefronts):
        want[order[ptr[l]:ptr[l + 1]]] = l
    assert np.array_equal(wave, want)
    assert len(np.unique(order)) == len(order)
    inside = np.ones(n, bool) if mask is None else mask
    assert np.array_equal(wave >= 0, inside)
    assert sched.full == (mask is None)
    # the level's sweep state, shared by its schedules
    assert sched.mat.done.shape == (n, 2) and sched.mat.ctl.shape == (2,)
    assert sched.mat.done.dtype == torch.int64
    assert not sched.mat.done.any() and not sched.mat.ctl.any()


CASES = [(k, fw, h) for k in ("7pt10", "nonsym") for fw in (True, False)
         for h in (None, "C", "F")]


@pytest.mark.parametrize("kind,forward,half", CASES)
@pytest.mark.parametrize("omega", [1.0, OMEGA])
def test_rule_in_random_orders_is_the_reference_and_jax(kind, forward, half,
                                                        omega):
    """Two random dependency-respecting orders: the reference's bits
    (f64), and the JAX package's gauss_seidel within 1e-14 relative;
    rows outside a masked half keep u."""
    M = _matrix(kind)
    n = M.shape[0]
    mask = None if half is None else _mask(n, half)
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward, mask=mask,
                              device="cpu")
    if kind == "nonsym" and half is None:
        assert sched.any_hazard
    rng = np.random.default_rng(2)
    u, f, v = (rng.standard_normal(n) for _ in range(3))
    ut, ft, vt = (torch.from_numpy(a) for a in (u, f, v))
    vv = None if omega == 1.0 else vt
    want = gs_sweep_reference(sched.slabs("cpu"), n, ut, ft, W, omega, vv)
    deps = _dependencies(sched, M)
    for seed in (0, 1):
        got = rule_sweep(sched, ut, ft, W, omega, vv, _random_order(deps, seed))
        assert torch.equal(got, want), seed
    if mask is not None:
        assert torch.equal(want[~torch.from_numpy(mask)],
                           ut[~torch.from_numpy(mask)])
    ref_s = jrelax.build_gs_schedule(JaxCSR.from_scipy(M), forward, mask=mask)
    jax_u = np.asarray(jrelax.gauss_seidel(
        ref_s, jnp.asarray(u), jnp.asarray(f), W, omega,
        None if vv is None else jnp.asarray(v)))
    assert np.abs(want.numpy() - jax_u).max() <= 1e-14 * np.abs(jax_u).max()
    assert gs_sweep_cuda.launches == 0  # CPU tensors: no kernel


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("omega", [1.0, OMEGA])
def test_rule_at_24_cubed(forward, omega):
    """The 24^3 fine level (13,824 rows, 70 wavefronts a direction): one
    random order, the reference's bits and the JAX package's sweep
    within 1e-14 relative."""
    M = _matrix("7pt24")
    n = M.shape[0]
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), forward, device="cpu")
    rng = np.random.default_rng(4)
    u, f, v = (rng.standard_normal(n) for _ in range(3))
    ut, ft, vt = (torch.from_numpy(a) for a in (u, f, v))
    vv = None if omega == 1.0 else vt
    want = gs_sweep_reference(sched.slabs("cpu"), n, ut, ft, W, omega, vv)
    order = _random_order(_dependencies(sched, M), 3)
    assert torch.equal(rule_sweep(sched, ut, ft, W, omega, vv, order), want)
    ref_s = jrelax.build_gs_schedule(JaxCSR.from_scipy(M), forward)
    jax_u = np.asarray(jrelax.gauss_seidel(
        ref_s, jnp.asarray(u), jnp.asarray(f), W, omega,
        None if vv is None else jnp.asarray(v)))
    assert np.abs(want.numpy() - jax_u).max() <= 1e-14 * np.abs(jax_u).max()


@pytest.mark.parametrize("kind", ["7pt10", "nonsym"])
@pytest.mark.parametrize("omega", [1.0, OMEGA])
def test_rule_with_f32_vectors(kind, omega):
    """f32 vectors, the slabs' f64 sums, one rounding of the update: the
    rule in a random order gives the reference's bits."""
    M = _matrix(kind)
    n = M.shape[0]
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), True, device="cpu")
    rng = np.random.default_rng(6)
    ut, ft, vt = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
                  for _ in range(3))
    vv = None if omega == 1.0 else vt
    want = gs_sweep_reference(sched.slabs("cpu"), n, ut, ft, W, omega, vv)
    order = _random_order(_dependencies(sched, M), 5)
    got = rule_sweep(sched, ut, ft, W, omega, vv, order)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_an_order_that_breaks_a_dependency_differs():
    """Sweeping the rows in reverse wavefront order reads out[j] before
    row j is written (the old value): the result is not the sweep's, so
    the random orders above really exercise the rule."""
    M = _matrix("7pt10")
    n = M.shape[0]
    sched = build_gs_schedule(CSRMatrix.from_scipy(M), True, device="cpu")
    rng = np.random.default_rng(9)
    ut, ft = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    want = gs_sweep_reference(sched.slabs("cpu"), n, ut, ft, W)
    bad = rule_sweep(sched, ut, ft, W, order=sched.order.numpy()[::-1].tolist())
    assert not torch.equal(bad, want)
    assert (bad - want).abs().max() > 1e-3
