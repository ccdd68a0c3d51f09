"""Strength and PMIS on the device (hypre_tpu_torch/solvers/amg/
device_coarsen.py) against the port's host PMIS and the JAX package's
hypre_tpu/solvers/amg/device_coarsen.py, on the same matrices.

Tolerances: none.  The LCG states are equal integers; every CF marker
(the port's device_pmis on the CPU and its numpy twin, the JAX
package's device_pmis and twin) is bitwise the port's pmis_coarsen; the
device_coarsen option gives the same hierarchy as the host PMIS, bitwise.
"""

import numpy as np
import pytest
import torch

from hypre_tpu.models import difconv_7pt as jax_difconv_7pt
from hypre_tpu.ops.csr import CSRMatrix as JaxCSR
from hypre_tpu.ops.dia import csr_to_dia as jax_csr_to_dia
from hypre_tpu.solvers.amg import device_coarsen as jax_dc
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops.csr import CSRMatrix
from hypre_tpu_torch.ops.dia import csr_to_dia
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions, boomeramg
from hypre_tpu_torch.solvers.amg.coarsen import pmis_coarsen
from hypre_tpu_torch.solvers.amg.device_coarsen import (
    device_pmis, lattice_pmis_host, lcg_states_host, strength_masks_impl)
from hypre_tpu_torch.solvers.amg.strength import strength_matrix
from hypre_tpu_torch.utils.lcg import M, lcg_fill
from torch_threads import one_thread  # noqa: F401


def test_lcg_states_match_values_and_jax():
    st = lcg_states_host(2747, 1000, skip=13)
    assert st.dtype == np.int32
    np.testing.assert_array_equal(st, jax_dc.lcg_states_host(2747, 1000, skip=13))
    np.testing.assert_array_equal(st.astype(np.float64) / M,
                                  lcg_fill(2747, 1000, skip=13))
    assert lcg_states_host(2747, 0).shape == (0,)


def _difconv():
    """The JAX package's 7-point convection-diffusion matrix, as the
    port's CSR."""
    return CSRMatrix.from_scipy(
        jax_difconv_7pt(16, 16, 16, ax=4.0, ay=2.0, az=1.0).to_scipy())


@pytest.mark.parametrize("make_matrix", [
    lambda: laplacian_7pt(24, 24, 24),
    lambda: laplacian_7pt(20, 16, 12, cx=1.0, cy=5.0, cz=40.0),
    _difconv,
], ids=["laplacian", "anisotropic", "difconv"])
def test_device_pmis_bitwise(make_matrix):
    A = make_matrix()
    n = A.shape[0]
    S = strength_matrix(A, 0.25, 0.9)
    cf_host = pmis_coarsen(S)
    D = csr_to_dia(A, "float64", "cpu")
    # the masks are the host strength graph's pattern
    masks = strength_masks_impl(D.data, D.offsets, 0.25, 0.9).numpy()
    rows = np.repeat(np.arange(n), np.diff(S.indptr))
    k_of = {o: k for k, o in enumerate(D.offsets)}
    ks = np.array([k_of[int(o)] for o in S.indices - rows])
    from_S = np.zeros_like(masks)
    from_S[ks, rows] = True
    np.testing.assert_array_equal(masks, from_S)

    cf_dev = device_pmis(D.data, D.offsets, n)
    assert cf_dev.dtype == torch.int8
    np.testing.assert_array_equal(cf_dev.numpy().astype(np.int64), cf_host)
    np.testing.assert_array_equal(
        lattice_pmis_host(D.data.numpy(), D.offsets, n).astype(np.int64),
        cf_host)
    # the JAX package's device PMIS and its twin on the same table
    Dj = jax_csr_to_dia(JaxCSR.from_scipy(A.to_scipy()), device=False)
    np.testing.assert_array_equal(
        np.asarray(jax_dc.device_pmis(Dj.data, Dj.offsets, n)).astype(np.int64),
        cf_host)
    np.testing.assert_array_equal(
        jax_dc.lattice_pmis_host(Dj.data, Dj.offsets, n).astype(np.int64),
        cf_host)


def test_device_coarsen_identical_hierarchy(monkeypatch):
    """device_coarsen=True gives the hierarchy of device_coarsen=False:
    the same CF markers and host operators, bitwise; the host PMIS then
    never sees level 0."""
    A = laplacian_7pt(16, 16, 16)
    common = dict(coarsen_type="pmis", interp_type="classical",
                  P_max_elmts=4, relax_down=18, relax_up=18,
                  lattice_shape=(16, 16, 16))
    h = BoomerAMG(A, BoomerAMGOptions(device_coarsen=False, **common),
                  device="cpu")
    host_rows = []

    def counting(S, seed):
        host_rows.append(S.shape[0])
        return pmis_coarsen(S, seed=seed)

    monkeypatch.setattr(boomeramg, "pmis_coarsen", counting)
    d = BoomerAMG(A, BoomerAMGOptions(device_coarsen=True, **common),
                  device="cpu")
    assert host_rows and 16**3 not in host_rows
    assert len(h._host_A) == len(d._host_A) > 2
    for lh, ld in zip(h._host_A, d._host_A):
        assert lh.shape == ld.shape and abs(lh - ld).max() == 0.0
    for ch, cd in zip(h._cf, d._cf):
        np.testing.assert_array_equal(ch, cd)
    assert [type(l.A).__name__ for l in h.levels] == [
        type(l.A).__name__ for l in d.levels]
