"""AMG-DD (hypre_tpu_torch/solvers/amg/amgdd.py) on the CPU against the
JAX package's: every domain's composite index sets and operators
bitwise, the host cycle and solve bitwise, the batched device cycle
(AMGDDDevice) in float64 within 1e-12 of the JAX package's and within
the JAX test's 1e-10 of the host cycle, in float32 within 1e-5; the
batched gathers bitwise their numpy meaning, and the 32-bit index
guard; the domain axis split over 4 and 8 shards
(`AMGDDDevice(..., mesh=...)`) against the JAX package's host cycle and
its AMGDDDevice with the domain axis sharded over the 8 virtual CPU
devices (tests/test_amg.py:457-475), f64 within 1e-12, bitwise the
unsharded port.  On the card the cycle runs the gather kernels,
launched as `cycle_launches` says (tests/test_torch_cuda.py::
test_amgdd_device_cycle_runs_the_gather_kernels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hypre_tpu.models as jm
from hypre_tpu.solvers.amg import AMGDD as JaxAMGDD
from hypre_tpu.solvers.amg import AMGDDOptions as JaxAMGDDOptions
from hypre_tpu.solvers.amg import BoomerAMG as JaxBoomerAMG
from hypre_tpu.solvers.amg import BoomerAMGOptions as JaxOptions
from hypre_tpu.solvers.amg.amgdd import AMGDDDevice as JaxAMGDDDevice
import hypre_tpu_torch.models as pm
from hypre_tpu_torch.solvers.amg import (AMGDD, AMGDDDevice, AMGDDOptions,
                                         BoomerAMG, BoomerAMGOptions)
from hypre_tpu_torch.solvers.amg.amgdd import (BatchedELL, batched_gather,
                                               _ell_stack)
from torch_family import chip_smoke, host, rel, same_csr
from torch_threads import one_thread  # noqa: F401

# tests/test_amg.py:446-449 (the device test) and :307-309
CLASSICAL = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
                 relax_down=18, relax_up=18, embed_level1=False)
EXT_I = dict(CLASSICAL, interp_type="ext+i")


def _pair(nx, amg_kw, **dd_kw):
    amg = BoomerAMG(pm.laplacian_7pt(nx, nx, nx), BoomerAMGOptions(**amg_kw),
                    device="cpu")
    jamg = JaxBoomerAMG(jm.laplacian_7pt(nx, nx, nx), JaxOptions(**amg_kw))
    return (AMGDD(amg, AMGDDOptions(**dd_kw)),
            JaxAMGDD(jamg, JaxAMGDDOptions(**dd_kw)))


@pytest.fixture(scope="module")
def dd10():
    """10^3, classical, 8 domains, padding 2 (the JAX device test)."""
    return _pair(10, CLASSICAL, num_domains=8, padding=2)


def test_composite_grids_are_the_jax_packages(dd10):
    dd, jdd = dd10
    assert len(dd.domains) == len(jdd.domains) == 8
    for dom, jdom in zip(dd.domains, jdd.domains):
        assert len(dom) == len(jdom)
        for lv, jlv in zip(dom, jdom):
            for key in ("idx", "gl", "dinv", "owned"):
                assert np.array_equal(lv[key], jlv[key])
            assert same_csr(lv["A"], jlv["A"])
            assert ("P" in lv) == ("P" in jlv)
            if "P" in lv:
                assert same_csr(lv["P"], jlv["P"])
        assert np.array_equal(dom[-1]["inv"], jdom[-1]["inv"])


def test_host_cycle_is_the_jax_packages(dd10):
    dd, jdd = dd10
    r = np.random.default_rng(0).standard_normal(1000)
    assert np.array_equal(dd.cycle(r), jdd.cycle(r))


def test_device_cycle_matches_jax_and_the_host_cycle(dd10):
    """AMGDDDevice in float64 against the JAX package's AMGDDDevice
    (1e-12) and the host cycle (the JAX test's 1e-10); float32 against
    the host cycle within 1e-5."""
    dd, jdd = dd10
    r = np.random.default_rng(0).standard_normal(1000)
    z_host = dd.cycle(r)
    dev = AMGDDDevice(dd, dtype=np.float64, device="cpu")
    z = dev.cycle(torch.from_numpy(r))
    z_jax = JaxAMGDDDevice(jdd, dtype=np.float64).cycle(jnp.asarray(r))
    assert z.dtype == torch.float64 and rel(z, z_jax) <= 1e-12
    np.testing.assert_allclose(host(z), z_host, rtol=1e-10, atol=1e-12)
    z32 = AMGDDDevice(dd, device="cpu").cycle(torch.from_numpy(r))
    assert z32.dtype == torch.float32 and rel(z32, z_host) <= 1e-5
    L = dev.num_levels
    assert dev.cycle_launches() == {"take_along_axis": 0,
                                    "flat_take": 2 * (L - 1) * 7 + 1}


@pytest.fixture(scope="module")
def jax_sharded_z(dd10):
    """The JAX AMGDDDevice's f64 cycle with its domain axis sharded over
    the 8 virtual devices, as tests/test_amg.py:457-475 places it."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hypre_tpu.parallel import make_mesh as jax_make_mesh

    _, jdd = dd10
    dev = JaxAMGDDDevice(jdd, dtype=np.float64)
    mesh = jax_make_mesh(8)
    dev.levels = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(
            mesh, P(*(("shard",) + (None,) * (x.ndim - 1)))))
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == 8 else x,
        dev.levels)
    dev.gidx = jax.device_put(dev.gidx, NamedSharding(mesh, P("shard")))
    dev.tgt = jax.device_put(dev.tgt, NamedSharding(mesh, P("shard")))
    dev._cycle = jax.jit(dev._cycle_impl)
    r = np.random.default_rng(0).standard_normal(1000)
    return r, np.asarray(dev.cycle(jnp.asarray(r)))


@pytest.mark.parametrize("S", [4, 8])
def test_sharded_device_cycle(dd10, jax_sharded_z, S):
    """8 domains on S shards (2 or 1 a shard): one residual distribution
    and the batched cycle a shard, the owned rows combined on shard 0;
    f64 within 1e-12 of the JAX host cycle and of the JAX package's
    sharded device cycle, bitwise the unsharded port; f32 bitwise the
    unsharded f32 cycle; launches a shard as `shard_launches` says."""
    from hypre_tpu_torch.parallel import make_mesh

    dd, jdd = dd10
    r, z_jax = jax_sharded_z
    mesh = make_mesh(devices=["cpu"] * S)
    dev = AMGDDDevice(dd, dtype=np.float64, mesh=mesh)
    z = dev.cycle(torch.from_numpy(r))
    assert z.dtype == torch.float64 and z.shape == (1000,)
    assert rel(z, jdd.cycle(r)) <= 1e-12 and rel(z, z_jax) <= 1e-12
    z1 = AMGDDDevice(dd, dtype=np.float64, device="cpu").cycle(
        torch.from_numpy(r))
    assert torch.equal(z, z1)
    L = dev.num_levels
    each = {"take_along_axis": 0, "flat_take": 2 * (L - 1) * 7 + 1}
    assert dev.shard_launches() == [each] * S
    assert dev.cycle_launches() == {k: S * v for k, v in each.items()}
    z32 = AMGDDDevice(dd, mesh=mesh).cycle(torch.from_numpy(r))
    assert torch.equal(z32, AMGDDDevice(dd, device="cpu").cycle(
        torch.from_numpy(r)))


def test_sharded_device_cycle_uneven(dd10):
    """8 domains on 3 shards (3, 3, 2) and on 16 (one domain a shard,
    the last 8 none: they launch nothing); PCG with the sharded cycle as
    its preconditioner takes the unsharded count."""
    from hypre_tpu_torch.ops.dia import freeze_auto, spmv
    from hypre_tpu_torch.ops.csr import CSRMatrix
    from hypre_tpu_torch.parallel import make_mesh
    from hypre_tpu_torch.solvers.krylov import PCGOptions, pcg

    dd, _ = dd10
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(1000))
    one = AMGDDDevice(dd, dtype=np.float64, device="cpu")
    for S in (3, 16):
        dev = AMGDDDevice(dd, dtype=np.float64,
                          mesh=make_mesh(devices=["cpu"] * S))
        assert torch.equal(dev.cycle(r), one.cycle(r))
        busy = [c["flat_take"] > 0 for c in dev.shard_launches()]
        assert busy == ([True] * 3 if S == 3 else [True] * 8 + [False] * 8)
    E = freeze_auto(CSRMatrix.from_scipy(dd.amg._host_A[0]), torch.float64,
                    "cpu")
    b = torch.ones(1000, dtype=torch.float64)
    opts = PCGOptions(tol=1e-8, max_iter=100)
    res = pcg(lambda x: spmv(E, x), b, M=dev.precond, opts=opts)
    ref = pcg(lambda x: spmv(E, x), b, M=one.precond, opts=opts)
    assert res.converged and res.num_iterations == ref.num_iterations


@pytest.mark.parametrize("nd,padding,max_its", [(1, 2, 8), (4, 2, 40)])
def test_solve_matches_jax(nd, padding, max_its):
    """tests/test_amg.py::test_amgdd_composite_grids (12^3, ext+i, b = A
    1, tol 1e-8): the same count, history and x, bitwise (both are the
    same numpy)."""
    dd, jdd = _pair(12, EXT_I, num_domains=nd, padding=padding)
    b = dd.amg._host_A[0] @ np.ones(12**3)
    res = dd.solve(b, tol=1e-8, max_iter=max_its)
    jres = jdd.solve(b, tol=1e-8, max_iter=max_its)
    assert res.converged and res.num_iterations == jres.num_iterations
    assert nd > 1 or res.num_iterations <= 8
    assert np.array_equal(res.res_norms, jres.res_norms)
    assert np.array_equal(res.x, jres.x)


def test_batched_gathers_take_along_the_domain_rows():
    """Both gathers of a batched ELL read u[d, cols[d, j]] (float32:
    take_along_axis over cols, float64: flat_take over d * ncols +
    cols), the numpy take_along_axis bit for bit."""
    rng = np.random.default_rng(9)
    mats = [sp.random(37, 29, density=0.2, random_state=s, format="csr")
            for s in range(5)]
    cols, vals = _ell_stack(mats, 40, np.float64)
    B = BatchedELL.build(cols, vals, 29, "cpu")
    u = rng.standard_normal((5, 29))
    want = np.take_along_axis(u, cols.reshape(5, -1), axis=1)
    for dt in (torch.float64, torch.float32):
        got = batched_gather(B, torch.from_numpy(u).to(dt))
        assert np.array_equal(host(got), want.astype(host(got).dtype))


def test_batched_ell_refuses_64_bit_indices():
    cols = np.zeros((2, 3, 4), np.int32)
    with pytest.raises(ValueError, match="32 bits"):
        BatchedELL.build(cols, np.zeros((2, 3, 4)), 2**30 + 1, "cpu")


@pytest.mark.slow
def test_jax_count_at_24_is_the_chip_pin():
    """The JAX package's AMGDD.solve count at 24^3 (classical, 8 domains,
    padding 2, b = ones, tol 1e-8): chip_smoke.py phase 16 (g)."""
    _, jdd = _pair(24, CLASSICAL, num_domains=8, padding=2)
    jres = jdd.solve(np.ones(24**3), tol=1e-8, max_iter=100)
    assert jres.converged and jres.num_iterations == chip_smoke().AUX_DD24
