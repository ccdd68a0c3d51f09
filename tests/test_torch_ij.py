"""The port's IJ interface and file I/O against the JAX package's, on the
CPU: the host accumulator bitwise, the device assembly to 1e-12 (as
tests/test_io.py holds the JAX package's), ex5's row-by-row flow, the
IJ file formats byte for byte both ways, and hierarchy checkpoints
across the packages (the same count, x to 1e-12), AIR refused."""

import contextlib
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.models import laplacian_7pt as jax_laplacian_7pt
from hypre_tpu.models.ij import IJMatrix as JaxIJMatrix
from hypre_tpu.models.ij import IJVector as JaxIJVector
from hypre_tpu.ops.csr import CSRMatrix as JaxCSRMatrix
from hypre_tpu.ops.dia import spmv as jax_spmv
from hypre_tpu.ops.transfer import unview
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.utils import io as jax_io
from hypre_tpu_torch.models import (IJMatrix, IJMatrixDevice, IJVector,
                                    difconv_7pt, laplacian_7pt)
from hypre_tpu_torch.ops import spmv
from hypre_tpu_torch.ops.dia import freeze_auto
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg
from hypre_tpu_torch.utils import io as port_io
from torch_threads import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _streams(seed, n=40, calls=30):
    """A seeded interleaved Set/AddTo stream: [(is_set, rows, cols, vals)]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(calls):
        k = rng.integers(1, 8)
        out.append((rng.random() < 0.4, rng.integers(0, n, k),
                    rng.integers(0, n, k), rng.standard_normal(k)))
    return out


def _feed(mats, stream):
    for is_set, r, c, v in stream:
        for M in mats:
            (M.set_values if is_set else M.add_to_values)(r, c, v)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_host_assembly_is_the_jax_accumulators(seed):
    port, jax_ = IJMatrix(40, 40), JaxIJMatrix(40, 40)
    _feed((port, jax_), _streams(seed))
    a, b = port.assemble(), jax_.assemble()
    for f in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert a.shape == b.shape


@pytest.mark.parametrize("seed", [5, 6])
def test_device_assembly_matches_host(seed):
    """The device assembly (on the CPU here) against the host
    accumulator, as tests/test_io.py holds the JAX package's."""
    host, dev = IJMatrix(40, 40), IJMatrixDevice(40, 40, device="cpu")
    _feed((host, dev), _streams(seed))
    Ah = host.assemble().to_scipy()
    Ad = dev.assemble().to_scipy()
    assert abs(Ah - Ad).max() < 1e-12
    assert np.array_equal(Ah.indptr, Ad.indptr)
    assert np.array_equal(Ah.indices, Ad.indices)


def test_ij_vector_matches_jax():
    rng = np.random.default_rng(3)
    pv, jv = IJVector(30), JaxIJVector(30)
    for _ in range(10):
        idx, vals = rng.integers(0, 30, 5), rng.standard_normal(5)
        for v in (pv, jv):
            v.add_to_values(idx, vals)
        idx = rng.integers(0, 30, 3)
        for v in (pv, jv):
            v.set_values(idx, vals[:3])
    assert np.array_equal(pv.assemble(), jv.assemble())


def test_ex5_flow_matches_examples_ex5():
    """examples/ex5.py's row-by-row IJ assembly and AMG-PCG at n 33, in
    the port, against the example's own run."""
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import ex5
    finally:
        sys.path.pop(0)
    argv = sys.argv
    sys.argv = ["ex5.py"]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            ref = ex5.main()
    finally:
        sys.argv = argv
    n = 33
    N = n * n
    h2 = (1.0 / (n + 1)) ** 2
    ij = IJMatrix(N, N)
    for i in range(N):
        cols, vals = [i], [4.0]
        if i >= n:
            cols.append(i - n); vals.append(-1.0)
        if i % n:
            cols.append(i - 1); vals.append(-1.0)
        if (i + 1) % n:
            cols.append(i + 1); vals.append(-1.0)
        if i + n < N:
            cols.append(i + n); vals.append(-1.0)
        ij.set_row(i, cols, vals)
    A = ij.assemble()
    rhs = IJVector(N)
    rhs.set_values(np.arange(N), np.full(N, h2))
    b = torch.from_numpy(rhs.assemble())
    amg = BoomerAMG(A, BoomerAMGOptions(
        coarsen_type="pmis", interp_type="ext+i", P_max_elmts=4,
        relax_down=18, relax_up=18), device="cpu")
    E = freeze_auto(A, torch.float64, "cpu")
    res = pcg(lambda x: spmv(E, x), b, M=amg.precond,
              opts=PCGOptions(tol=1e-7, max_iter=200, two_norm=True))
    assert res.converged and res.num_iterations == int(ref.num_iterations)
    x = res.x.numpy()
    assert np.abs(x - np.asarray(ref.x)).max() <= 1e-12 * np.abs(x).max()


def test_matrix_file_is_the_jax_packages_byte_for_byte(tmp_path):
    A = difconv_7pt(3, 3, 3)
    p = port_io.write_ij_matrix(A, str(tmp_path / "port.A"))
    j = jax_io.write_ij_matrix(JaxCSRMatrix.from_scipy(A.to_scipy()),
                               str(tmp_path / "jax.A"))
    assert p.endswith(".00000")
    assert open(p, "rb").read() == open(j, "rb").read()
    # each package reads the other's file
    for path, reader in ((j, port_io.read_ij_matrix),
                         (p, jax_io.read_ij_matrix)):
        B = reader(path[: -len(".00000")])
        assert abs(B.to_scipy() - A.to_scipy()).max() == 0


def test_vector_file_is_the_jax_packages_byte_for_byte(tmp_path):
    v = np.random.default_rng(1).standard_normal(17)
    p = port_io.write_ij_vector(v, str(tmp_path / "port.b"))
    j = jax_io.write_ij_vector(v, str(tmp_path / "jax.b"))
    assert open(p, "rb").read() == open(j, "rb").read()
    assert np.array_equal(port_io.read_ij_vector(str(tmp_path / "jax.b")),
                          jax_io.read_ij_vector(str(tmp_path / "port.b")))


# the JAX package's checkpoint test's options (tests/test_io.py) one way,
# HMIS with the default GS relaxation the other
CKPT_JAX_TO_PORT = dict(coarsen_type="pmis", interp_type="ext+i",
                        relax_down=18, relax_up=18)
CKPT_PORT_TO_JAX = dict(coarsen_type="hmis", interp_type="classical",
                        P_max_elmts=4)


def _npz(path):
    z = np.load(path)
    return {k: z[k] for k in z.files}


def test_checkpoint_jax_to_port(tmp_path):
    kw = CKPT_JAX_TO_PORT
    A = jax_laplacian_7pt(8, 8, 8)
    jamg = JaxBoomerAMG(A, JaxOptions(**kw))
    p = str(tmp_path / "jax.npz")
    jax_io.save_amg_hierarchy(jamg, p)
    amg = port_io.load_amg_hierarchy(p, device="cpu")
    assert amg.num_levels == jamg.num_levels
    bh = A.to_scipy() @ np.ones(512)
    r1 = jamg.solve(jnp.asarray(bh), tol=1e-8, max_iter=40)
    r2 = amg.solve(torch.from_numpy(bh), tol=1e-8, max_iter=40)
    assert int(r1.num_iterations) == r2.num_iterations
    np.testing.assert_allclose(r2.x.numpy(), np.asarray(r1.x), rtol=1e-12)


def test_checkpoint_port_to_jax(tmp_path):
    kw = CKPT_PORT_TO_JAX
    amg = BoomerAMG(laplacian_7pt(8, 8, 8), BoomerAMGOptions(**kw),
                    device="cpu")
    p, pj = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port_io.save_amg_hierarchy(amg, p)
    jax_io.save_amg_hierarchy(JaxBoomerAMG(jax_laplacian_7pt(8, 8, 8),
                                           JaxOptions(**kw)), pj)
    # the same keys, arrays and options JSON as the JAX package writes
    zp, zj = _npz(p), _npz(pj)
    assert sorted(zp) == sorted(zj)
    assert all(np.array_equal(zp[k], zj[k]) for k in zp)
    jamg = jax_io.load_amg_hierarchy(p)
    bh = laplacian_7pt(8, 8, 8).to_scipy() @ np.ones(512)
    r1 = jamg.solve(jnp.asarray(bh), tol=1e-8, max_iter=40)
    r2 = amg.solve(torch.from_numpy(bh), tol=1e-8, max_iter=40)
    assert r2.converged and int(r1.num_iterations) == r2.num_iterations
    np.testing.assert_allclose(r2.x.numpy(), np.asarray(r1.x), rtol=1e-12)


def test_checkpoint_reloads_lattice_hierarchy_bitwise(tmp_path):
    """A hierarchy on the lattice forms (level 1 embedded with the device
    RAP's values, the non-Galerkin filter on) reloads to the same levels:
    PCG gives the same count and x bitwise."""
    nx = 20
    opts = BoomerAMGOptions(coarsen_type="pmis", interp_type="classical",
                            P_max_elmts=4, relax_down=18, relax_up=18,
                            nongalerkin_tol=0.02, lattice_shape=(nx, nx, nx))
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), opts, device="cpu")
    assert amg.levels[1].A.num_rows == nx**3  # embedded
    p = str(tmp_path / "lat.npz")
    port_io.save_amg_hierarchy(amg, p)
    amg2 = port_io.load_amg_hierarchy(p, device="cpu")
    res = []
    for a in (amg, amg2):
        A0 = a.levels[0].A
        res.append(pcg(lambda x: spmv(A0, x), torch.ones(nx**3,
                                                         dtype=torch.float64),
                       M=a.precond, opts=PCGOptions(tol=1e-8, max_iter=60,
                                                    two_norm=True)))
    assert res[0].converged and res[0].num_iterations == res[1].num_iterations
    assert torch.equal(res[0].x, res[1].x)


def test_checkpoint_options_round_trip(tmp_path):
    """JSON turns tuples into lists; the loaded options have them back."""
    opts = BoomerAMGOptions(relax_down=18, relax_up=18,
                            level_relax_weights=(1.0, 0.8),
                            grid_relax_type=(18, 18, 18, 9),
                            grid_relax_points=((0,), (0,), (0,), (0,)))
    amg = BoomerAMG(laplacian_7pt(6, 6, 6), opts, device="cpu")
    p = str(tmp_path / "o.npz")
    port_io.save_amg_hierarchy(amg, p)
    assert port_io.load_amg_hierarchy(p, device="cpu").opts == opts


AIR = dict(coarsen_type="pmis", interp_type="classical", restrict_type=1,
           relax_down=0, relax_up=0, relax_weight=0.7)


def test_checkpoint_refuses_air(tmp_path):
    """The format holds no R: the port refuses to save an AIR hierarchy
    and to load one the JAX package saved."""
    A = difconv_7pt(8, 8, 8)
    amg = BoomerAMG(A, BoomerAMGOptions(**AIR), device="cpu")
    with pytest.raises(ValueError, match="AIR"):
        port_io.save_amg_hierarchy(amg, str(tmp_path / "p.npz"))
    p = str(tmp_path / "j.npz")
    jax_io.save_amg_hierarchy(JaxBoomerAMG(JaxCSRMatrix.from_scipy(
        A.to_scipy()), JaxOptions(**AIR)), p)
    with pytest.raises(ValueError, match="AIR"):
        port_io.load_amg_hierarchy(p, device="cpu")


def test_jax_checkpoint_drops_air_r(tmp_path):
    """Pins the JAX package's loss: its loaded AIR hierarchy restricts
    with P^T, not the AIR R it saved from."""
    from hypre_tpu.models import difconv_7pt as jax_difconv_7pt

    jamg = JaxBoomerAMG(jax_difconv_7pt(8, 8, 8), JaxOptions(**AIR))
    assert jamg._host_R[0] is not None
    p = str(tmp_path / "j.npz")
    jax_io.save_amg_hierarchy(jamg, p)
    loaded = jax_io.load_amg_hierarchy(p)
    assert all(R is None for R in loaded._host_R)
    v = np.random.default_rng(2).standard_normal(512)
    Rv = np.asarray(jax_spmv(unview(list(loaded.levels))[0].R,
                             jnp.asarray(v)))
    PTv = jamg._host_P[0].T @ v
    assert np.abs(Rv - PTv).max() <= 1e-12 * np.abs(PTv).max()
    assert np.abs(jamg._host_R[0] @ v - PTv).max() > 1e-3
