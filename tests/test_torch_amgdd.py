"""AMG-DD (hypre_tpu_torch/solvers/amg/amgdd.py) on the CPU against the
JAX package's: every domain's composite index sets and operators
bitwise, the host cycle and solve bitwise, the batched device cycle
(AMGDDDevice) in float64 within 1e-12 of the JAX package's and within
the JAX test's 1e-10 of the host cycle, in float32 within 1e-5; the
batched gathers bitwise their numpy meaning, and the 32-bit index
guard.  On the card the cycle runs the gather kernels, launched as
`cycle_launches` says (tests/test_torch_cuda.py::
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
