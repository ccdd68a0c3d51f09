"""The port's distributed setup chains (hypre_tpu_torch/parallel/
dist_setup.py for lattice operators, dist_csr_setup.py for general CSR)
against the JAX package's (tests/test_dist_setup.py,
tests/test_dist_csr_setup.py), the port's shards on
`make_mesh(devices=["cpu"] * S)`, f64.

Held bitwise: the lattice chain's CF split, P and coarse operator
against the port's serial device chain, and its CF and P against the
JAX package's sharded chain (the coarse operator there within 1e-13:
XLA contracts some of the RAP's multiply-adds into FMAs on the CPU);
the general chain's CF against the host PMIS and P against the host
classical interpolation at both transitions.  The coarse operators,
par_matmul and par_transpose within 1e-12 of the serial products.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from hypre_tpu.models import laplacian_7pt as jlap7
from hypre_tpu.models import laplacian_27pt as jlap27
from hypre_tpu.parallel.dist_setup import dist_lattice_setup as jax_dist
from hypre_tpu.parallel.dist_setup import (
    local_laplacian_dia_block as jax_local_block)
from hypre_tpu.parallel.mesh import make_mesh as jax_mesh
from hypre_tpu.solvers.amg.coarsen import pmis_coarsen as jax_pmis
from hypre_tpu.solvers.amg.interp import classical_interp as jax_interp
from hypre_tpu.solvers.amg.rap import galerkin_rap as jax_rap
from hypre_tpu.solvers.amg.strength import strength_matrix as jax_strength
from hypre_tpu_torch.ops.device_setup import device_classical_interp, device_rap
from hypre_tpu_torch.ops.dia import DIAMatrix
from hypre_tpu_torch.parallel import ParCSR, make_mesh
from hypre_tpu_torch.parallel.dist_csr_setup import (dist_csr_hierarchy,
                                                     dist_csr_setup,
                                                     dist_pmis, par_matmul,
                                                     par_transpose)
from hypre_tpu_torch.parallel.dist_setup import (dist_lattice_setup,
                                                 local_laplacian_dia_block)
from hypre_tpu_torch.solvers.amg.coarsen import pmis_coarsen
from hypre_tpu_torch.solvers.amg.device_coarsen import device_pmis
from hypre_tpu_torch.solvers.amg.interp import classical_interp
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.utils.errors import HypreError
from torch_threads import one_thread  # noqa: F401


def cpu_mesh(S):
    return make_mesh(devices=["cpu"] * S)


def cat(blocks, axis=-1):
    return torch.cat([b.cpu() for b in blocks], dim=axis).numpy()


def stacked(P):
    """A ParCSR's host row blocks as one scipy matrix."""
    return sp.vstack(P.host_blocks).tocsr()[: P.n]


def assert_zero(D, tol=0.0):
    D = D.tocoo()
    assert D.nnz == 0 or float(np.abs(D.data).max()) <= tol


# ----------------------------------------------------------------------
# the lattice chain
# ----------------------------------------------------------------------

def test_local_dia_block_matches_jax():
    for lo, hi in ((0, 512), (128, 384), (500, 512)):
        blk, offs = local_laplacian_dia_block(8, 8, 8, lo, hi)
        jblk, joffs = jax_local_block(8, 8, 8, lo, hi)
        assert offs == tuple(joffs) and np.array_equal(blk, jblk)


def serial_chain(data, offsets, n, max_elmts, ngt):
    """The port's single-image device chain on one table."""
    t = torch.from_numpy(data)
    cf = device_pmis(t, offsets, n)
    P, rowmax = device_classical_interp(t, cf, offsets=offsets,
                                        trunc_factor=0.0, max_elmts=max_elmts)
    keep = [k for k in range(len(offsets)) if rowmax[k] > 0]
    offs_P = tuple(offsets[k] for k in keep)
    P = P[torch.tensor(keep)]
    A1, offs_1 = device_rap(DIAMatrix(P, offs_P, n, n),
                            DIAMatrix(t, offsets, n, n), tol=ngt)
    return cf.numpy(), P.numpy(), offs_P, A1.numpy(), offs_1


def lattice_16(S):
    n = 16**3
    n_loc = n // S
    blocks, offsets = zip(*(local_laplacian_dia_block(
        16, 16, 16, s * n_loc, (s + 1) * n_loc) for s in range(S)))
    return list(blocks), offsets[0], n


@pytest.mark.parametrize("ngt,S", [(0.0, 8), (0.02, 4)])
def test_dist_lattice_setup_bitwise_16(ngt, S):
    """16^3 over 8 shards (two z-planes each), the table generated a
    shard at a time: CF, P and the coarse operator bitwise the port's
    serial device chain; CF and P bitwise the JAX package's sharded
    chain, its coarse operator within 1e-13 (tests/test_dist_setup.py's
    own bound against its serial chain).  With the non-Galerkin filter
    on 4 shards, against the serial chain."""
    blocks, offsets, n = lattice_16(S)
    data = np.concatenate(blocks, axis=1)
    cf, P, offs_P, A1, offs_1 = dist_lattice_setup(
        blocks, offsets, n, cpu_mesh(S), max_elmts=4,
        nongalerkin_tol=ngt)
    scf, sP, soffs_P, sA1, soffs_1 = serial_chain(data, offsets, n, 4, ngt)
    assert np.array_equal(cat(cf), scf)
    assert offs_P == soffs_P and np.array_equal(cat(P), sP)
    assert offs_1 == soffs_1 and np.array_equal(cat(A1), sA1)
    if ngt:
        return
    jcf, jP, joffs_P, jA1, joffs_1 = jax_dist(
        data, offsets, n, jax_mesh(S), trunc_factor=0.0, max_elmts=4,
        nongalerkin_tol=ngt)
    assert np.array_equal(cat(cf), np.asarray(jcf))
    assert offs_P == tuple(joffs_P) and np.array_equal(cat(P), np.asarray(jP))
    assert offs_1 == tuple(joffs_1)
    assert float(np.abs(cat(A1) - np.asarray(jA1)).max()) <= 1e-13


def test_dist_lattice_filter_past_a_shard_raises():
    """The non-Galerkin filter reads each coarse entry's mirror one
    offset away, up to 3 x 256 = 768 rows at 16^3: past a shard of 512
    (8 shards) the halo shift refuses it, as the JAX package's does
    (test_jax_filter_past_a_shard_raises)."""
    blocks, offsets, n = lattice_16(8)
    with pytest.raises(HypreError, match="halo width 768"):
        dist_lattice_setup(blocks, offsets, n, cpu_mesh(8), max_elmts=4,
                           nongalerkin_tol=0.02)


def test_jax_filter_past_a_shard_raises():
    from hypre_tpu.utils.errors import HypreError as JaxError

    blocks, offsets, n = lattice_16(8)
    with pytest.raises(JaxError, match="halo width 768"):
        jax_dist(np.concatenate(blocks, axis=1), offsets, n, jax_mesh(8),
                 max_elmts=4, nongalerkin_tol=0.02)


def test_run_shards_all_gather_under_contention():
    """The lockstep threads of the lattice chain: 16 shards (more than
    the cores), a short switch interval, 200 all-gathers each; every
    gather sees every shard's value of that round (a slot overwritten
    before it was read would show)."""
    import sys
    import threading

    from hypre_tpu_torch.parallel.dist_setup import run_shards

    S, rounds = 16, 200

    def body(s, comm):
        return [comm.all_gather(s, (s, r)) == [(t, r) for t in range(S)]
                for r in range(rounds)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = run_shards(S, body)
    finally:
        sys.setswitchinterval(old)
    assert all(all(ok) for ok in out) and threading.active_count() < S


def test_run_shards_raises_a_shards_error():
    """A shard that fails breaks the barrier: the others stop and its
    error reaches the caller (no shard waits forever)."""
    from hypre_tpu_torch.parallel.dist_setup import run_shards

    def body(s, comm):
        comm.all_gather(s, s)
        if s == 2:
            raise ValueError("shard 2 fails")
        return comm.all_gather(s, s)

    with pytest.raises(ValueError, match="shard 2 fails"):
        run_shards(4, body)


def test_dist_lattice_setup_needs_divisible_n():
    data, offs = local_laplacian_dia_block(5, 5, 5, 0, 125)
    with pytest.raises(HypreError, match="divisible"):
        dist_lattice_setup(data, offs, 125, cpu_mesh(4))


# ----------------------------------------------------------------------
# the general-CSR chain
# ----------------------------------------------------------------------

def _mats():
    yield "7pt-12", jlap7(12, 12, 12).to_scipy().tocsr()
    yield "27pt-8", jlap27(8, 8, 8).to_scipy().tocsr()
    A = jlap7(10, 10, 10).to_scipy().tocsr()
    J = A.copy()
    J.data = J.data * (1.0 + 0.1 * np.random.RandomState(7).rand(J.nnz))
    yield "jitter-10", ((J + J.T) / 2).tocsr()
    yield "7pt-11", jlap7(11, 11, 11).to_scipy().tocsr()  # a short last shard


@pytest.mark.parametrize("name,A", list(_mats()), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_dist_pmis_bitwise(name, A):
    """The sharded PMIS: bitwise the host PMIS on the assembled matrix,
    the port's and the JAX package's, on tests/test_dist_csr_setup.py's
    four matrices over 8 shards."""
    cf = dist_pmis(ParCSR(A, cpu_mesh(8)))
    assert np.array_equal(cf, pmis_coarsen(strength_matrix(A)))
    assert np.array_equal(cf, jax_pmis(jax_strength(A)))


def test_dist_setup_level0_parity():
    """One level on 8 shards: CF bitwise, P bitwise the host classical
    interpolation (the JAX package's too), the coarse operator within
    1e-12 of the serial Galerkin product."""
    A = jlap7(12, 12, 12).to_scipy().tocsr()
    cf, Pd, A1d = dist_csr_setup(ParCSR(A, cpu_mesh(8)))
    S = jax_strength(A)
    cf_h = jax_pmis(S)
    assert np.array_equal(cf, cf_h)
    Ph = jax_interp(A, S, cf_h)
    assert stacked(Pd).shape == Ph.shape
    assert_zero(stacked(Pd) - Ph)
    assert_zero(stacked(Pd) - classical_interp(A, strength_matrix(A), cf))
    A1h = jax_rap(A, Ph)
    assert_zero(stacked(A1d) - A1h, 1e-12 * np.abs(A1h.data).max())


def test_dist_hierarchy_two_transitions():
    """0 -> 1 and 1 -> 2 sharded: at each level the chain matches the
    serial one run on the operator the chain produced."""
    A = jlap7(12, 12, 12).to_scipy().tocsr()
    levels, Ps, cfs = dist_csr_hierarchy(ParCSR(A, cpu_mesh(8)),
                                         max_levels=3)
    assert len(levels) == 3
    for l in range(2):
        Al = stacked(levels[l])
        S = strength_matrix(Al)
        cf_h = pmis_coarsen(S)
        assert np.array_equal(cfs[l], cf_h)
        assert_zero(stacked(Ps[l]) - classical_interp(Al, S, cf_h))
        assert levels[l + 1].n == int((cf_h > 0).sum())


def test_par_matmul_and_transpose():
    """A @ A, A @ P with a rectangular P, P^T and the triple product on
    8 shards against scipy (tests/test_dist_csr_setup.py's case)."""
    mesh = cpu_mesh(8)
    Ad = jlap7(8, 8, 8).to_scipy().tocsr()
    A = ParCSR(Ad, mesh)
    assert_zero(stacked(par_matmul(A, A)) - Ad @ Ad, 1e-12)
    rng = np.random.default_rng(5)
    Pd = (sp.random(512, 97, density=0.02, random_state=rng, format="csr")
          + sp.eye(512, 97, format="csr") * 0.5).tocsr()
    P = ParCSR(Pd, mesh)
    assert_zero(stacked(par_matmul(A, P)) - Ad @ Pd, 1e-12)
    Pt = par_transpose(P)
    assert (Pt.n, Pt.m) == (97, 512)
    assert_zero(stacked(Pt) - Pd.T.tocsr())
    RAP = par_matmul(par_transpose(P), par_matmul(A, P))
    assert_zero(stacked(RAP) - (Pd.T @ (Ad @ Pd)).tocsr(), 1e-10)
