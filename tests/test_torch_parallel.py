"""The port's sharded layer (hypre_tpu_torch/parallel/: partition, mesh
and collectives, halo plans, ParCSR, ParDIA, par_vector; with
models.ij.IJMatrixSharded and models.laplacian_7pt_row_block) against
the JAX package's, on the 8 virtual CPU devices of tests/conftest.py
for the JAX side and `make_mesh(devices=["cpu"] * S)` for the port's.

Host arrays (partitions, halo plans, the ParCSR ELL arrays and counts,
the ParDIA tables, the IJ assembly's blocks) are held bitwise; products
(matvecs, `diag_matvec_fn`, the halo exchanges) within 1e-12 relative
to the largest entry in f64 (the port's one ELL launch sums a row's
diag and offd slots in one pass, the JAX package adds two sums);
integer exchanges and maxima exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.sharding import PartitionSpec as JP

import hypre_tpu.parallel as jpar
from hypre_tpu.models import laplacian_5pt_2d as jlap5
from hypre_tpu.models import laplacian_7pt as jlap7
from hypre_tpu.models import laplacian_7pt_row_block as jrow_block
from hypre_tpu.models.ij import IJMatrixSharded as JaxIJSharded
from hypre_tpu.ops.csr import CSRMatrix as JaxCSR
from hypre_tpu.ops.dia import csr_to_dia as jax_csr_to_dia
from hypre_tpu.parallel import halo as jhalo
from hypre_tpu.parallel.par_dia import ParDIA as JaxParDIA
from hypre_tpu.solvers.krylov import PCGOptions as JaxPCGOptions
from hypre_tpu.solvers.krylov import pcg as jax_pcg
from hypre_tpu_torch import convert
from hypre_tpu_torch.models import (IJMatrixSharded, laplacian_7pt,
                                    laplacian_7pt_row_block)
from hypre_tpu_torch.ops.csr import CSRMatrix
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.parallel import (ParCSR, ParDIA, ParVector,
                                      block_partition, make_mesh, par_dot,
                                      par_norm)
from hypre_tpu_torch.parallel.halo import exchange, reverse_exchange
from hypre_tpu_torch.parallel.mesh import all_gather, pmax, ppermute, psum
from hypre_tpu_torch.parallel.par_dia import dia_table
from hypre_tpu_torch.parallel.par_vector import par_mass_dot
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from hypre_tpu_torch.utils.errors import HypreError
from torch_threads import one_thread  # noqa: F401

TOL = 1e-12


def cpu_mesh(S):
    return make_mesh(devices=["cpu"] * S)


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max(initial=0.0)), 1e-300)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max(initial=0.0)) <= tol * scale


def both_csr(M, S, **kw):
    """(port ParCSR, JAX ParCSR) of scipy M on S shards."""
    return (ParCSR(CSRMatrix.from_scipy(M), cpu_mesh(S), **kw),
            jpar.ParCSR(JaxCSR.from_scipy(M), jpar.make_mesh(S), **kw))


def same_csr_arrays(P, J):
    for k in ("diag_cols", "diag_data", "offd_cols", "offd_data"):
        a, b = getattr(P, k), np.asarray(getattr(J, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(P.diag_counts, J.diag_counts)
    assert np.array_equal(P.offd_counts, J.offd_counts)
    assert all(np.array_equal(a, b) for a, b in zip(P.col_maps, J.col_maps))
    p, j = P.plan, J.plan
    assert (p.offsets, p.ghost_width, p.use_allgather, p.n_shards) == (
        tuple(j.offsets), j.ghost_width, j.use_allgather, j.n_shards)
    for a, b in zip(p.send_idx + p.recv_pos, j.send_idx + j.recv_pos):
        assert np.array_equal(a, np.asarray(b)) and a.dtype == np.int32
    if p.use_allgather:
        assert np.array_equal(p.ghost_gids, np.asarray(j.ghost_gids))
    for a, b in ((P.part, J.part), (P.col_part, J.col_part)):
        assert (a.n_global, a.n_shards, a.rows_per_shard) == (
            b.n_global, b.n_shards, b.rows_per_shard)


def rand_rect(n, m, seed, density=0.02):
    rng = np.random.default_rng(seed)
    return (sp.random(n, m, density=density, random_state=rng, format="csr")
            + sp.eye(n, m, format="csr") * 0.5).tocsr()


# ----------------------------------------------------------------------
# partition, mesh, collectives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,S", [(315, 2), (315, 8), (100, 8), (10, 8),
                                 (4096, 4)])
def test_block_partition_matches_jax(n, S):
    """Including short and empty trailing shards (100 on 8: shard 7
    empty; 10 on 8: shards 2-7 empty) and the clamped owner."""
    p, j = block_partition(n, S), jpar.block_partition(n, S)
    assert (p.n_global, p.n_shards, p.rows_per_shard, p.n_padded) == (
        j.n_global, j.n_shards, j.rows_per_shard, j.n_padded)
    gid = np.arange(p.n_padded + 5)
    assert np.array_equal(p.owner(gid), j.owner(gid))
    assert np.array_equal(p.local(gid), j.local(gid))
    assert [p.shard_rows(s) for s in range(S)] == [j.shard_rows(s)
                                                   for s in range(S)]


def test_make_mesh_needs_cuda_devices_unless_given():
    have = torch.cuda.device_count()
    with pytest.raises(HypreError, match="requested"):
        make_mesh(have + 1)
    if have == 0:
        with pytest.raises(HypreError):
            make_mesh()
    m = make_mesh(devices=["cpu"] * 3)
    assert m.shape == {"shard": 3} and m.devices == (torch.device("cpu"),) * 3
    with pytest.raises(HypreError):
        make_mesh(2, devices=["cpu"] * 3)


def test_collectives():
    blocks = [torch.full((3,), float(s + 1), dtype=torch.float64)
              for s in range(4)]
    out = ppermute(blocks, [(s, s + 1) for s in range(3)])
    assert [float(o[0]) for o in out] == [0.0, 1.0, 2.0, 3.0]
    assert all(float(t.sum()) == 30.0 for t in psum(blocks))
    assert all(float(t.max()) == 4.0 for t in pmax(blocks))
    assert [float(v) for v in all_gather(blocks)[2]] == sum(
        ([float(s + 1)] * 3 for s in range(4)), [])


# ----------------------------------------------------------------------
# halo plans and ParCSR
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4, 8])
def test_par_csr_arrays_plans_and_matvec(S):
    """tests/test_parallel.py's matvec case: every host array and the
    plan bitwise, the product and the diag-block product within 1e-12
    of the JAX package's and of scipy's."""
    M = jlap7(9, 7, 5).to_scipy().tocsr()
    P, J = both_csr(M, S)
    same_csr_arrays(P, J)
    x = np.random.default_rng(0).standard_normal(M.shape[0])
    y = P.unpad(P.matvec(P.pad_vec(x)))
    close(y, np.asarray(J.unpad(J.matvec(J.pad_vec(x)))))
    close(y, M @ x)
    close(P.unpad(P.diag_matvec_fn(P.pad_vec(x))),
          np.asarray(J.diag_matvec_fn(J.pad_vec(x)))[: M.shape[0]])


def test_par_csr_allgather_plan():
    """Every shard needs every other: past max_offsets=2 the plan is the
    dense all-gather one (tests/test_parallel.py's wide-coupling case)."""
    rng = np.random.default_rng(1)
    M = sp.random(64, 64, density=0.5, random_state=rng, format="csr")
    P, J = both_csr(M, 8, max_offsets=2)
    assert P.plan.use_allgather
    same_csr_arrays(P, J)
    x = rng.standard_normal(64)
    y = P.unpad(P.matvec(P.pad_vec(x)))
    close(y, np.asarray(J.unpad(J.matvec(J.pad_vec(x)))))
    close(y, M @ x)


def test_par_csr_banded_uses_two_offsets():
    P = ParCSR(CSRMatrix.from_scipy(jlap5(16, 16).to_scipy()), cpu_mesh(8))
    assert not P.plan.use_allgather and len(P.plan.offsets) <= 2


def test_par_csr_rectangular_p_and_r():
    """P (n x nc, col_part the coarse partition) and R = P^T (col_part
    the fine one), as ParAMG shards its transfers: arrays bitwise,
    products within 1e-12."""
    n, nc, S = 512, 97, 4
    Pm = rand_rect(n, nc, 5)
    cpart, fpart = jpar.block_partition(nc, S), jpar.block_partition(n, S)
    for M, cp in ((Pm, cpart), (Pm.T.tocsr(), fpart)):
        P, J = both_csr(M, S, col_part=block_partition(cp.n_global, S))
        same_csr_arrays(P, J)
        x = np.random.default_rng(2).standard_normal(M.shape[1])
        y = P.unpad(P.matvec(P.pad_col_vec(x)))
        close(y, np.asarray(J.unpad(J.matvec(J.pad_col_vec(x)))))
        close(y, M @ x)


def test_par_csr_empty_trailing_shard():
    """n = 100 on 8 shards: shard 6 holds 4 rows, shard 7 none (the
    block partition rounds the shard length up to 16).  The JAX package
    and the port build the same arrays and products."""
    M = jlap7(10, 10, 1).to_scipy().tocsr()
    P, J = both_csr(M, 8)
    assert [len(P.part.shard_rows(s)) for s in range(8)][-2:] == [4, 0]
    same_csr_arrays(P, J)
    x = np.random.default_rng(3).standard_normal(100)
    close(P.unpad(P.matvec(P.pad_vec(x))), M @ x)
    close(P.unpad(P.matvec(P.pad_vec(x))),
          np.asarray(J.unpad(J.matvec(J.pad_vec(x)))))


@pytest.fixture(scope="module")
def exchange_case():
    """A 27-point operator on 4 shards (three plan offsets) and a
    forward / reverse exchange of the JAX package inside shard_map."""
    from hypre_tpu.models import laplacian_27pt as jlap27

    M = jlap27(6, 6, 6).to_scipy().tocsr()
    P, J = both_csr(M, 4, max_offsets=3)
    jmesh = jpar.make_mesh(4)
    per, gw = J.part.rows_per_shard, J.plan.ghost_width

    fwd = jax.jit(jax.shard_map(
        lambda x: jhalo.exchange(J.plan, x, "shard")[None], mesh=jmesh,
        in_specs=JP("shard"), out_specs=JP("shard")))

    def rev(combine):
        return jax.jit(jax.shard_map(
            lambda c: jhalo.reverse_exchange(J.plan, c[0], "shard", per,
                                             combine)[None],
            mesh=jmesh, in_specs=JP("shard"), out_specs=JP("shard")))
    return P, J, fwd, rev, per, gw


@pytest.mark.parametrize("dtype", [np.float64, np.int32])
def test_exchange_and_reverse_exchange(exchange_case, dtype):
    P, J, fwd, rev, per, gw = exchange_case
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4 * per) if dtype == np.float64
         else rng.integers(-50, 50, 4 * per)).astype(dtype)
    ghosts = exchange(P.plan, [torch.from_numpy(x[s * per:(s + 1) * per])
                               for s in range(4)])
    ref = np.asarray(fwd(jnp.asarray(x)))
    assert np.array_equal(np.stack([g.numpy() for g in ghosts]), ref)
    c = (rng.standard_normal((4, gw + 1)) if dtype == np.float64
         else rng.integers(0, 9, (4, gw + 1))).astype(dtype)
    c[:, gw] = 0  # the sink carries nothing
    for combine in ("add", "max"):
        out = reverse_exchange(P.plan, [torch.from_numpy(r) for r in c], per,
                               combine)
        got = np.stack([o.numpy() for o in out])
        want = np.asarray(rev(combine)(jnp.asarray(c)))
        if dtype == np.int32 or combine == "max":
            assert np.array_equal(got, want)
        else:
            close(got, want)


def test_convert_carries_par_csr(exchange_case):
    P, J = exchange_case[:2]
    C = convert.par_csr_from_numpy(J, cpu_mesh(4))
    same_csr_arrays(C, J)
    x = np.random.default_rng(5).standard_normal(J.n)
    assert np.array_equal(C.unpad(C.matvec(C.pad_vec(x))),
                          P.unpad(P.matvec(P.pad_vec(x))))


# ----------------------------------------------------------------------
# ParDIA, row blocks, IJ
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S", [4, 8])
def test_par_dia_and_row_blocks(S):
    """tests/test_par_amg.py's ParDIA / row-block case at 16^3: the
    per-shard tables bitwise, the strip-halo product and the diag-block
    product within 1e-12 of the JAX package's; the row blocks bitwise
    and from_row_blocks' product the same."""
    nx = 16
    n = nx**3
    A = jlap7(nx, nx, nx)
    D = jax_csr_to_dia(A, device=False)
    J = JaxParDIA.from_dia(D, jpar.make_mesh(S))
    data, offs = dia_table(A.to_scipy())
    assert offs == tuple(D.offsets)
    assert np.array_equal(data, np.asarray(D.data)[:, :n])
    Pd = ParDIA(data, offs, n, cpu_mesh(S))
    assert np.array_equal(Pd.data, np.asarray(J.data))
    Pf = ParDIA.from_dia(csr_to_dia(laplacian_7pt(nx, nx, nx), "float64",
                                    "cpu"), cpu_mesh(S))
    assert Pf.offsets == Pd.offsets and np.array_equal(Pf.data, Pd.data)
    x = np.random.default_rng(2).standard_normal(n)
    y = Pd.unpad(Pd.matvec(Pd.pad_vec(x)))
    close(y, np.asarray(J.unpad(J.matvec(J.pad_vec(x)))))
    close(y, A.to_scipy() @ x)
    close(Pd.unpad(Pd.diag_matvec_fn(Pd.pad_vec(x))),
          np.asarray(J.diag_matvec_fn(J.pad_vec(x)))[:n])
    C = convert.par_dia_from_numpy(J, cpu_mesh(S))
    assert np.array_equal(C.unpad(C.matvec(C.pad_vec(x))), y)

    per = block_partition(n, S).rows_per_shard
    blocks = [laplacian_7pt_row_block(nx, nx, nx, min(s * per, n),
                                      min(s * per + per, n)) for s in range(S)]
    for b, s in zip(blocks, range(S)):
        jb = jrow_block(nx, nx, nx, min(s * per, n), min(s * per + per, n))
        assert (b != jb).nnz == 0 and np.array_equal(b.indices, jb.indices)
    Ab = ParCSR.from_row_blocks(blocks, (n, n), cpu_mesh(S))
    close(Ab.unpad(Ab.matvec(Ab.pad_vec(x))), y)


def test_par_dia_halo_past_a_shard_raises():
    A = laplacian_7pt(4, 4, 8).to_scipy()
    data, offs = dia_table(A)
    with pytest.raises(HypreError, match="halo"):
        ParDIA(data, offs, 128, cpu_mesh(16))  # halo 16 > 8 rows a shard


def test_ij_sharded_matches_jax():
    """Sets and AddTos from every shard, rows owned elsewhere included,
    a Set after Adds and Adds after a Set: the owners' blocks and every
    ParCSR array bitwise the JAX package's, and the same matrix as
    from_row_blocks of the assembled rows."""
    n, S = 60, 4
    rng = np.random.default_rng(7)
    P = IJMatrixSharded(n, n, mesh=cpu_mesh(S))
    J = JaxIJSharded(n, n, mesh=jpar.make_mesh(S))
    for call in range(40):
        shard = int(rng.integers(S))
        rows = rng.integers(0, n, 5)
        cols = np.clip(rows + rng.integers(-2, 3, 5), 0, n - 1)
        vals = rng.standard_normal(5)
        kind = "set_values" if call % 3 == 0 else "add_to_values"
        getattr(P, kind)(shard, rows, cols, vals)
        getattr(J, kind)(shard, rows, cols, vals)
    Pa, Ja = P.assemble(), J.assemble()
    for a, b in zip(Pa.host_blocks, Ja.host_blocks):
        assert (a != b).nnz == 0
    same_csr_arrays(Pa, Ja)
    R = ParCSR.from_row_blocks(Pa.host_blocks, (n, n), cpu_mesh(S))
    x = rng.standard_normal(n)
    assert np.array_equal(Pa.unpad(Pa.matvec(Pa.pad_vec(x))),
                          R.unpad(R.matvec(R.pad_vec(x))))


# ----------------------------------------------------------------------
# sharded vectors and the Krylov loop on them
# ----------------------------------------------------------------------

def test_par_dot_norm_and_vector():
    mesh = cpu_mesh(8)
    V = ParVector(mesh, 100)
    x = V.from_host(np.arange(100.0))
    assert len(x) == 8 and all(b.shape == (16,) for b in x)
    assert np.array_equal(V.to_host(x), np.arange(100.0))
    Jx = jpar.ParCSR(JaxCSR.from_scipy(jlap5(10, 10).to_scipy()),
                     jpar.make_mesh(8)).pad_vec(np.arange(100.0))
    assert float(par_dot(x, x)) == pytest.approx(float(jpar.par_dot(Jx, Jx)),
                                                 rel=1e-15)
    assert float(par_norm(x)) == pytest.approx(float(jpar.par_norm(Jx)),
                                               rel=1e-15)
    y = V.from_host(np.ones(100))
    assert par_mass_dot(x, [x, y]).tolist() == [328350.0, 4950.0]


def test_par_pcg_matches_jax_sharded_solve():
    """tests/test_parallel.py's PCG case (8^3, 8 shards, tol 1e-10): the
    port's pcg on sharded vectors (tuples of blocks) takes the JAX
    package's count and residual history and the serial solution."""
    M = jlap7(8, 8, 8).to_scipy().tocsr()
    P, J = both_csr(M, 8)
    b = np.ones(M.shape[0])
    res = pcg(P.matvec_fn, P.pad_vec(b), opts=PCGOptions(tol=1e-10,
                                                         max_iter=200))
    jres = jax_pcg(J.matvec_fn, J.pad_vec(b),
                   opts=JaxPCGOptions(tol=1e-10, max_iter=200))
    assert res.num_iterations == int(jres.num_iterations)
    its = res.num_iterations
    close(res.res_norms[: its + 1].numpy(),
          np.asarray(jres.res_norms)[: its + 1], 1e-10)
    ser = pcg(lambda v: torch.from_numpy(M @ v.numpy()), torch.ones(512,
              dtype=torch.float64), opts=PCGOptions(tol=1e-10, max_iter=200))
    assert ser.num_iterations == its
    close(P.unpad(res.x), ser.x.numpy(), 1e-10)
