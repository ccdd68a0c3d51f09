"""The sharded struct stack (hypre_tpu_torch/parallel/par_struct.py,
make_mesh_nd, and `shard_solver`) against the JAX
package's, in f64 on the CPU: the port's shards are
`make_mesh(devices=["cpu"] * S)` / `make_mesh_nd(..., devices=...)`, the
JAX side runs on the 8 virtual CPU devices of tests/conftest.py.

Tolerances:
  * the layouts' blocks are the JAX shardings' index maps exactly;
  * the sharded struct_matvec is within 1e-12 of the JAX sharded one
    (the JAX package sums a point's terms in its own fused order) and
    bitwise the port's serial one (each point's serial terms in the
    serial order, on a block widened by its ghost planes);
  * sharded PFMG, SMG with its planes cut (gathered whole) and struct
    Jacobi take the serial port's iterations and give its x bit for
    bit: only the stop test's dot differs (the shards' dots added in
    shard order);
  * SMG with its planes whole on each shard solves each shard's planes
    in a batch of its own, so x is within 1e-12 of the serial one;
  * PCG (PFMG-PCG, hybrid) on sharded vectors: its dots are the shards'
    dots, so the history is within 1e-12 of the serial run's;
  * SparseMSG's sharded transfers are ParCSR ELL products (a row's diag
    entries, then its offd ones), so x is within 1e-12;
  * iteration counts are the JAX package's (its serial solves; the JAX
    package's own tests pin sharded == serial), residuals of the [REF]
    line within the 2e-9 the struct driver tests allow.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.parallel import make_mesh as jax_make_mesh
from hypre_tpu.parallel.mesh import make_mesh_nd as jax_make_mesh_nd
from hypre_tpu.parallel.par_struct import shard_struct as jax_shard_struct
from hypre_tpu.parallel.par_struct import vector_sharding as jax_sharding
from hypre_tpu.solvers.struct_ls import PFMG as JaxPFMG
from hypre_tpu.solvers.struct_ls import PFMGOptions as JaxPFMGOptions
from hypre_tpu.struct import StructGrid as JaxGrid
from hypre_tpu.struct import StructMatrix as JaxStructMatrix
from hypre_tpu.struct import struct_matvec as jax_matvec
from hypre_tpu_torch.drivers import struct as port_driver
from hypre_tpu_torch.parallel import make_mesh, make_mesh_nd
from hypre_tpu_torch.parallel.par_struct import (StructLayout, shard_solver,
                                                 shard_struct, vector_sharding)
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from hypre_tpu_torch.solvers.struct_ls import PFMG, PFMGOptions
from hypre_tpu_torch.struct import StructGrid, StructMatrix, struct_matvec
from hypre_tpu_torch.utils.errors import HypreError
from test_torch_struct_driver import JAX_RUNS, _chip_smoke
from torch_threads import one_thread  # noqa: F401


def stencil7(shape, cx=1.0, cy=1.0, cz=1.0):
    ones = np.ones(shape)
    return {(0, 0, 0): 2 * (cx + cy + cz) * ones,
            (-1, 0, 0): -cx * ones, (1, 0, 0): -cx * ones,
            (0, -1, 0): -cy * ones, (0, 1, 0): -cy * ones,
            (0, 0, -1): -cz * ones, (0, 0, 1): -cz * ones}


def poisson7(shape, *c, periodic=None):
    return StructMatrix.from_dict(stencil7(shape, *c),
                                  StructGrid(shape, periodic), device="cpu")


def jax_poisson7(shape, *c):
    return JaxStructMatrix.from_dict(stencil7(shape, *c), JaxGrid(shape))


def cpu_mesh(S):
    return make_mesh(devices=["cpu"] * S)


def cpu_mesh_nd(dims):
    return make_mesh_nd(dims, devices=["cpu"] * int(np.prod(dims)))


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def driver(line):
    with contextlib.redirect_stdout(io.StringIO()):
        return port_driver.run(line.split(), device="cpu")


# -- the mesh and the layouts -------------------------------------------------

def test_make_mesh_nd():
    mesh = cpu_mesh_nd((2, 4))
    jmesh = jax_make_mesh_nd((2, 4))
    assert mesh.axis_names == jmesh.axis_names == ("shard0", "shard1")
    assert mesh.shape == dict(jmesh.shape) == {"shard0": 2, "shard1": 4}
    assert mesh.size == 8 and mesh.dims == np.asarray(jmesh.devices).shape
    assert make_mesh_nd((2, 2), axes=("x", "y"),
                        devices=["cpu"] * 4).axis_names == ("x", "y")
    with pytest.raises(HypreError, match="CUDA"):
        make_mesh_nd((torch.cuda.device_count() + 1, 1))
    with pytest.raises(HypreError):
        make_mesh_nd((2, 2), devices=["cpu"] * 3)


@pytest.mark.parametrize("dims, shape, gax", [
    ((8,), (16, 12, 10), 0), ((2, 4), (8, 8, 10), (0, 1)),
    ((4,), (12, 12, 12), 2)])
def test_layout_blocks_are_the_jax_shardings(dims, shape, gax):
    """Each shard's block is the JAX NamedSharding's index map of the
    device in the same place of the process grid."""
    if len(dims) == 1:
        mesh, jmesh = cpu_mesh(dims[0]), jax_make_mesh(dims[0])
        names = "shard"
    else:
        mesh, jmesh = cpu_mesh_nd(dims), jax_make_mesh_nd(dims)
        names = mesh.axis_names
    lay = vector_sharding(mesh, 3, names, gax).layout(shape)
    jmap = jax_sharding(jmesh, 3, names, gax).devices_indices_map(shape)
    for s, dev in enumerate(np.asarray(jmesh.devices).reshape(-1)):
        want = tuple(sl.indices(n)[:2] for sl, n in zip(jmap[dev], shape))
        assert lay.box(s) == want


def test_uneven_split_and_coarse_projection():
    """A length that does not divide: ceil(n / P) a process, the last
    short or empty (as GSPMD tiles it).  Coarsening projects: coarse k on
    the owner of fine 2k; 96 on 4 shards gives 24, 12, 6, 3, then
    2 / 1 / 2 / 1 planes, and 6 planes on 4 shards an empty one."""
    lay = StructLayout.even(cpu_mesh(4), (10, 3, 3))
    assert lay.ranges[0] == ((0, 3), (3, 6), (6, 9), (9, 10))
    lay = StructLayout.even(cpu_mesh(4), (96, 2, 2))
    sizes = []
    for _ in range(5):
        sizes.append([hi - lo for lo, hi in lay.ranges[0]])
        lay = lay.coarsen(0)
    assert sizes == [[24] * 4, [12] * 4, [6] * 4, [3] * 4, [2, 1, 2, 1]]
    lay = StructLayout.even(cpu_mesh(4), (2, 2, 12), grid_axis=2)
    lay = lay.coarsen(2).coarsen(2)
    assert lay.ranges[0] == ((0, 1), (1, 2), (2, 3), (3, 3))
    with pytest.raises(HypreError, match="replicated"):
        StructLayout.even(cpu_mesh_nd((2, 4)), (8, 8, 8), "shard0", 0)


# -- the ghost exchange and the matvec ----------------------------------------

def test_ghost_planes_carry_the_corners():
    """On a 2 x 2 process grid the ghosts of axis 1 are exchanged over
    the blocks widened by axis 0's, so the widened block is the global
    array's window, corners included; zero past the edges."""
    mesh = cpu_mesh_nd((2, 2))
    x = np.random.default_rng(3).standard_normal((6, 8, 3))
    lay = StructLayout.even(mesh, x.shape, mesh.axis_names, (0, 1))
    pad = np.pad(x, ((1, 1), (2, 2), (0, 0)))
    wide = lay.ghost(lay.from_host(x), (1, 2, 0))
    for s, w in enumerate(wide):
        (a0, b0), (a1, b1), _ = lay.box(s)
        assert np.array_equal(w.numpy(), pad[a0:b0 + 2, a1:b1 + 4])


@pytest.mark.parametrize("grid", ["1d", "2d"])
def test_sharded_matvec_matches_jax(grid):
    """tests/test_par_struct.py's two matvecs: 8 shards along axis 0 at
    (16, 12, 10), a 2 x 4 process grid at (8, 8, 10)."""
    if grid == "1d":
        shape, names, gax = (16, 12, 10), "shard", 0
        mesh, jmesh = cpu_mesh(8), jax_make_mesh(8)
    else:
        shape, names, gax = (8, 8, 10), ("shard0", "shard1"), (0, 1)
        mesh, jmesh = cpu_mesh_nd((2, 4)), jax_make_mesh_nd((2, 4))
    x = np.random.default_rng(int(grid[0])).standard_normal(shape)
    jA = jax_poisson7(shape, 2.0, 3.0, 40.0)
    jA_sh, (jx,) = jax_shard_struct(jA, [x], jmesh, names, gax)
    y_jax = np.asarray(jax.jit(jax_matvec)(jA_sh, jx))
    A = poisson7(shape, 2.0, 3.0, 40.0)
    A_sh, (xs,) = shard_struct(A, [x], mesh, names, gax)
    y = A_sh.layout.to_host(struct_matvec(A_sh, xs))
    assert rel(y, y_jax) <= 1e-12
    assert np.array_equal(y, struct_matvec(A, torch.from_numpy(x)).numpy())
    assert all(b.shape == A_sh.layout.block_shape(s) for s, b in enumerate(xs))


@pytest.mark.parametrize("case", ["uneven", "thin", "periodic", "wide"])
def test_sharded_matvec_edges(case):
    """Bitwise the serial product: a length that does not divide (13 on
    4), blocks thinner than the reach (3 planes on 4 shards, reach 2,
    one empty), a periodic cut axis (its ghosts wrap), and a 27-point
    stencil with constant entries on a 2 x 2 grid (boxed and not)."""
    rng = np.random.default_rng(7)
    if case == "uneven":
        shape, mesh, names, gax = (13, 5, 4), cpu_mesh(4), "shard", 0
        A = poisson7(shape, 1.0, 2.0, 3.0)
    elif case == "thin":
        shape, mesh, names, gax = (3, 6, 5), cpu_mesh(4), "shard", 0
        ent = {o: rng.standard_normal(shape)
               for o in [(0, 0, 0), (2, 0, 0), (-2, 1, 0), (1, 0, -1)]}
        A = StructMatrix.from_dict(ent, StructGrid(shape), device="cpu")
    elif case == "periodic":
        shape, mesh, names, gax = (12, 6, 5), cpu_mesh(4), "shard", 0
        A = poisson7(shape, periodic=(12, 0, 0))
    else:
        shape, mesh = (7, 6, 5), cpu_mesh_nd((2, 2))
        names, gax = mesh.axis_names, (0, 1)
        offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                for k in (-1, 0, 1)]
        ent = {o: rng.standard_normal(shape) for o in offs[1:]}
        ent[offs[0]] = 0.25
        A = StructMatrix.from_dict(ent, StructGrid(shape), device="cpu")
    x = rng.standard_normal(shape)
    want = struct_matvec(A, torch.from_numpy(x)).numpy()
    for M in (A, A.boxed()):
        M_sh, (xs,) = shard_struct(M, [x], mesh, names, gax)
        y = M_sh.layout.to_host(struct_matvec(M_sh, xs, alpha=1.0))
        assert np.array_equal(y, want)


# -- PFMG ----------------------------------------------------------------------

@pytest.mark.parametrize("grid", ["1d", "2d"])
def test_sharded_pfmg_matches_jax_serial(grid):
    """tests/test_par_struct.py's two PFMG solves (8 shards at (16, 12,
    12), skip_relax 0, b = ones; 2 x 4 at (8, 8, 10), tol 1e-8, b = A 1):
    the JAX package's serial count and x within 1e-10, and the serial
    port's x bit for bit."""
    if grid == "1d":
        shape, mesh, names, gax = (16, 12, 12), cpu_mesh(8), "shard", 0
        kw = dict(tol=1e-6, max_iter=60, skip_relax=0)
        b = np.ones(shape)
    else:
        shape, mesh = (8, 8, 10), cpu_mesh_nd((2, 4))
        names, gax = mesh.axis_names, (0, 1)
        kw = dict(tol=1e-8, max_iter=40)
        b = np.array(jax_matvec(jax_poisson7(shape, 2.0, 3.0, 40.0),
                                jnp.ones(shape)))
    jres = JaxPFMG(jax_poisson7(shape, 2.0, 3.0, 40.0),
                   JaxPFMGOptions(**kw)).solve(jnp.asarray(b))
    pf = PFMG(poisson7(shape, 2.0, 3.0, 40.0), PFMGOptions(**kw),
              device="cpu")
    serial = pf.solve(torch.from_numpy(b))
    lay = vector_sharding(mesh, 3, names, gax).layout(shape)
    res = shard_solver(pf, lay).solve(lay.from_host(b))
    x = lay.to_host(res.x)
    assert res.num_iterations == serial.num_iterations == int(
        jres.num_iterations)
    np.testing.assert_allclose(x, np.asarray(jres.x), rtol=1e-10, atol=1e-10)
    assert np.array_equal(x, serial.x.numpy())
    assert shard_solver(pf, lay) is shard_solver(pf, lay)  # cut once a layout


@pytest.mark.parametrize("case", ["uneven_rb", "empty_coarse", "periodic"])
def test_sharded_pfmg_cases(case):
    """Bitwise the serial port, the same count: a length that does not
    divide with red-black relaxation (relax_type 2, the masks from each
    block's global index); the last axis cut on 4 shards at -c 2 3 40
    (the coarse levels project to 2 / 1 / 2 / 1 planes, then leave a
    shard empty); a periodic cut axis."""
    if case == "uneven_rb":
        shape, gax, c, per = (13, 12, 11), 0, (1.0, 1.0, 1.0), None
        kw = dict(tol=1e-8, max_iter=40, relax_type=2)
    elif case == "empty_coarse":
        shape, gax, c, per = (12, 12, 12), 2, (2.0, 3.0, 40.0), None
        kw = dict(tol=1e-6, max_iter=40)
    else:
        shape, gax, c, per = (16, 8, 8), 0, (1.0, 1.0, 1.0), (16, 0, 0)
        kw = dict(tol=1e-6, max_iter=40)
    A = poisson7(shape, *c, periodic=per)
    pf = PFMG(A, PFMGOptions(**kw), device="cpu")
    b = np.ones(shape)
    serial = pf.solve(torch.from_numpy(b))
    A_sh, (bs,) = shard_struct(A, [b], cpu_mesh(4), grid_axis=gax)
    on = shard_solver(pf, A_sh.layout)
    res = on.solve(bs)
    assert serial.converged and res.num_iterations == serial.num_iterations
    assert np.array_equal(A_sh.layout.to_host(res.x), serial.x.numpy())
    blocks = [[lvl.A.layout.block_shape(s)[gax] for s in range(4)]
              for lvl in on.levels]
    if case == "empty_coarse":
        assert [2, 1, 2, 1] in blocks and any(0 in b for b in blocks)
    if case == "periodic":
        assert A_sh.layout.periodic == (16, 0, 0)


def test_sharded_pfmg_pcg():
    """PFMG-PCG (struct.c solver 11) on 4 shards: pcg over the tuple
    helpers, the JAX driver's count at 8^3 and the serial history
    within 1e-12."""
    res_s = driver("-n 8 8 8 -solver 11")
    A, pf = res_s.A, res_s.solver
    assert res_s.num_iterations == JAX_RUNS["-n 8 8 8 -solver 11"][0]
    A_sh, (bs,) = shard_struct(A, [np.ones(A.shape)], cpu_mesh(4))
    opts = PCGOptions(tol=1e-6, max_iter=200, two_norm=True)
    res = pcg(lambda x: struct_matvec(A_sh, x), bs,
              M=shard_solver(pf, A_sh.layout).precond, opts=opts)
    k = res.num_iterations
    assert k == res_s.num_iterations
    h, hs = res.res_norms[:k + 1].numpy(), res_s.res_norms[:k + 1].numpy()
    assert rel(h, hs) <= 1e-12
    assert rel(A_sh.layout.to_host(res.x), res_s.x.numpy()) <= 1e-12


# -- SMG, SparseMSG, Jacobi, hybrid -------------------------------------------

@pytest.mark.parametrize("gax", [0, 2])
def test_sharded_smg_ref_line(gax):
    """smgbase3d (12^3 -c 2 3 40, [REF] 4 and 8.971901e-07) on 4 shards:
    along axis 0 its planes are cut (gathered whole, bitwise the serial
    x), along axis 2 each plane is whole on a shard and the coarse
    layouts leave shards empty (x within 1e-12)."""
    line, iters, rel_pin = _chip_smoke().STRUCT_REF[1]
    assert line == "-n 12 12 12 -c 2.0 3.0 40 -solver 0"
    res_s = driver(line)
    A, smg = res_s.A, res_s.solver
    A_sh, (bs,) = shard_struct(A, [np.ones(A.shape)], cpu_mesh(4),
                               grid_axis=gax)
    on = shard_solver(smg, A_sh.layout)
    res = on.solve(bs)
    assert res.converged and res.num_iterations == iters
    assert abs(float(res.rel_residual_norm) - rel_pin) < 2e-9
    x = A_sh.layout.to_host(res.x)
    if gax == 0:
        assert np.array_equal(x, res_s.x.numpy())
    else:
        assert rel(x, res_s.x.numpy()) <= 1e-12
        assert any(lvl.A.layout.block_shape(s)[2] == 0
                   for lvl in on.levels for s in range(4))


@pytest.mark.parametrize("grid", ["1d", "2d"])
def test_sharded_sparse_msg(grid):
    """SparseMSG at 8^3 (the JAX driver's count) on 4 shards and on a
    2 x 2 grid: every transfer a ParCSR (one ELL launch a shard), x
    within 1e-12 of the serial port's."""
    line = "-n 8 8 8 -solver 2"
    res_s = driver(line)
    A, msg = res_s.A, res_s.solver
    mesh = cpu_mesh(4) if grid == "1d" else cpu_mesh_nd((2, 2))
    names = "shard" if grid == "1d" else mesh.axis_names
    A_sh, (bs,) = shard_struct(A, [np.ones(A.shape)], mesh, names,
                               0 if grid == "1d" else (0, 1))
    on = shard_solver(msg, A_sh.layout)
    res = on.solve(bs)
    assert res.num_iterations == res_s.num_iterations == JAX_RUNS[line][0]
    assert rel(A_sh.layout.to_host(res.x), res_s.x.numpy()) <= 1e-12
    transfers = len(msg.Rdev) + len(msg.Pdev)
    assert on.cycle_launches() == {"ell_spmv": 4 * transfers}


@pytest.mark.parametrize("line", ["-n 8 8 8 -solver 8", "-n 8 8 8 -solver 25"])
def test_sharded_jacobi_and_hybrid(line):
    """StructJacobi (bitwise the serial x) and the hybrid solver (its two
    PCG phases on sharded vectors, x within 1e-12) on 4 shards cut
    along axis 1, the JAX driver's counts."""
    res_s = driver(line)
    A, sol = res_s.A, res_s.solver
    A_sh, (bs,) = shard_struct(A, [np.ones(A.shape)], cpu_mesh(4),
                               grid_axis=1)
    res = shard_solver(sol, A_sh.layout).solve(bs)
    assert res.num_iterations == res_s.num_iterations == JAX_RUNS[line][0]
    x = A_sh.layout.to_host(res.x)
    if "-solver 8" in line:
        assert np.array_equal(x, res_s.x.numpy())
    else:
        assert rel(x, res_s.x.numpy()) <= 1e-12


@pytest.mark.slow
def test_jax_count_is_the_chip_pin():
    """The JAX driver's SparseMSG count at 16^3 (~50 s on a CPU), which
    chip_smoke.py phase 20 (e) holds the sharded solve to (PS_MSG16)."""
    from hypre_tpu.drivers import struct as jax_driver

    line, want = _chip_smoke().PS_MSG16
    with contextlib.redirect_stdout(io.StringIO()):
        res = jax_driver.run(line.split())
    assert int(res.num_iterations) == want
