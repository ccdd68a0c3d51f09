"""The device-side embedded RAP of the port (ops/device_rap.py) against
the JAX package's (hypre_tpu/ops/device_rap.py), on the same inputs.

The inputs are the port's host hierarchy (bitwise the JAX package's,
tests/test_torch_setup.py) lifted onto the fine lattice: the embedded
P0 and the fine A0 as DIA, both handed to both packages.  Tolerances:
the plan's tables equal as integers; the transpose bitwise; the
filtered level-1 operator in f64 <= 1e-12 relative, in f32 sums stored
as bf16 <= 1 bf16 ulp, and in both the number of differing entries is
stated (N_DIFFER: none on the CPU, where both packages run the same
IEEE operations in the same order); both at tol 0 and 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypre_tpu.ops import device_rap as jax_rap
from hypre_tpu.ops.dia import DIAMatrix as JaxDIA
from hypre_tpu_torch.models import laplacian_7pt
from hypre_tpu_torch.ops.csr import CSRMatrix, torch_dtype
from hypre_tpu_torch.ops.device_rap import (dia_transpose_device,
                                            embedded_rap_device,
                                            plan_embedded_rap)
from hypre_tpu_torch.ops.dia import (build_embedded_dia, csr_to_dia,
                                     embedded_offsets)
from hypre_tpu_torch.solvers.amg import BoomerAMG, BoomerAMGOptions
from torch_threads import one_thread  # noqa: F401

PLAIN = dict(coarsen_type="pmis", P_max_elmts=4, relax_down=18,
             relax_up=18, embed_level1=False, relocate_level2=False,
             collapse_coarse_n=0)
CONFIGS = {"f64": dict(dtype="float64"),
           "f32": dict(dtype="float32", mat_dtype="bfloat16")}
N_DIFFER = 0  # entries of L1 A that differ from the JAX package's


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _bits(a) -> np.ndarray:
    """Values as numpy, bf16 as 16-bit patterns (torch or JAX input)."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    if a.dtype == jnp.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))
    return np.asarray(a)


def _ordered(bits16: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers ordered like the values, so that a
    difference of 1 is one ulp."""
    b = bits16.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _lattice_inputs(nx, cfg, interp, tol):
    """(embedded P0, fine A0 as DIA, the plan's four offset lists, host
    P0, level-1 positions cpos0) of an nx^3 hierarchy."""
    amg = BoomerAMG(laplacian_7pt(nx, nx, nx), BoomerAMGOptions(
        interp_type=interp, nongalerkin_tol=tol, **PLAIN, **CONFIGS[cfg]),
        device="cpu")
    o = amg.opts
    A0h, P0, A1 = amg._host_A[0], amg._host_P[0], amg._host_A[1]
    n0 = A0h.shape[0]
    idx = np.arange(n0, dtype=np.int64)
    cpos0 = np.flatnonzero(amg._cf[0] > 0).astype(np.int64)
    mdt = torch_dtype(o.mat_dtype or o.dtype)
    P_emb = build_embedded_dia(P0, idx, cpos0, n0, mdt, "cpu")
    A0 = csr_to_dia(CSRMatrix.from_scipy(A0h), o.dtype, "cpu")
    offs = (embedded_offsets(P0, idx, cpos0), embedded_offsets(A0h, idx, idx),
            embedded_offsets(amg._host_A1_unf, cpos0, cpos0),
            embedded_offsets(A1, cpos0, cpos0))
    return P_emb, A0, offs, P0, cpos0


@pytest.mark.parametrize("interp", ["classical", "ext+i"])
@pytest.mark.parametrize("nx", [12, 16])
def test_plan_tables_equal_jax(nx, interp):
    _, _, offs, _, _ = _lattice_inputs(nx, "f64", interp, 0.02)
    plan, ref = plan_embedded_rap(*offs), jax_rap.plan_embedded_rap(*offs)
    assert plan.keys() == ref.keys()
    for k in ("unf", "T", "valid", "slot", "filt"):
        assert plan[k].dtype == ref[k].dtype and np.array_equal(plan[k], ref[k]), k
    assert (plan["diag_j"], plan["tmax"]) == (ref["diag_j"], ref["tmax"])


def test_plan_without_a_diagonal_raises():
    with pytest.raises(Exception, match="diagonal"):
        plan_embedded_rap([1], [0], [2], [2])


@pytest.mark.parametrize("cfg", ["f64", "f32"])
def test_dia_transpose_device_bitwise(cfg):
    P_emb, _, _, P0, cpos0 = _lattice_inputs(12, cfg, "ext+i", 0.0)
    R = dia_transpose_device(P_emb)
    n0 = P_emb.num_rows
    ref = jax_rap.dia_transpose_device(
        JaxDIA(data=_to_jax(P_emb.data), offsets=P_emb.offsets,
               num_rows=n0, num_cols=n0), n0)
    assert R.offsets == tuple(ref.offsets) == tuple(-o for o in reversed(P_emb.offsets))
    assert np.array_equal(_bits(R.data), _bits(ref.data))
    # and the transpose built from the host values
    host = build_embedded_dia(P0.T.tocsr(), cpos0, np.arange(n0), n0,
                              P_emb.data.dtype, "cpu")
    assert host.offsets == R.offsets
    assert np.array_equal(_bits(R.data), _bits(host.data))


@pytest.mark.parametrize("tol", [0.0, 0.02])
@pytest.mark.parametrize("cfg", ["f64", "f32"])
@pytest.mark.parametrize("nx,interp", [(12, "classical"), (16, "classical"),
                                       (12, "ext+i")])
def test_embedded_rap_device_matches_jax(nx, interp, cfg, tol):
    P_emb, A0, offs, _, _ = _lattice_inputs(nx, cfg, interp, tol)
    plan = plan_embedded_rap(*offs)
    mdt = P_emb.data.dtype
    data, diag, lump = embedded_rap_device(P_emb, A0, plan, tol, mdt)
    n = A0.num_rows
    jdata, jdiag, jlump = jax_rap.embedded_rap_device(
        JaxDIA(data=_to_jax(P_emb.data), offsets=P_emb.offsets, num_rows=n,
               num_cols=n),
        JaxDIA(data=_to_jax(A0.data), offsets=A0.offsets, num_rows=n,
               num_cols=n),
        jax_rap.plan_embedded_rap(*offs), tol, n,
        jnp.bfloat16 if mdt == torch.bfloat16 else jnp.float64)
    assert tuple(data.shape) == (len(offs[3]), n) == tuple(jdata.shape)
    assert data.dtype == mdt
    a, b = _bits(data), _bits(jdata)
    if cfg == "f64":
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 1e-12
        for mine, ref in ((diag, jdiag), (lump, jlump)):
            ref = np.asarray(ref)
            assert np.abs(mine.numpy() - ref).max() <= 1e-12 * np.abs(ref).max() + 1e-300
    else:
        assert np.abs(_ordered(a) - _ordered(b)).max() <= 1
    assert int((a != b).sum()) == N_DIFFER
    # the stored pattern is the host filter's: every stored offset of
    # the host product holds a value somewhere
    assert (np.abs(data.double().numpy()).max(1) > 0).all()
    if tol == 0.0:
        assert len(offs[3]) == len(offs[2])  # nothing filtered, nothing lumped
        assert not lump.abs().max()
    elif interp == "ext+i":  # whole offsets dropped, their mass lumped
        assert len(offs[3]) < len(offs[2]) and lump.abs().max() > 0


def test_device_rap_against_host_values():
    """The level-1 operator from the device pass against the host
    product embedded (device_rap=False), f64, 24^3 lattice: the same
    offsets; each off-diagonal entry within 1e-12 of the host value,
    relative (the products summed in another order), and where the host
    holds 0 within 8 eps of the largest entry (a cancellation residue);
    the diagonal row is read back through float32 before the lumped mass
    is added (the JAX package's device_rap.py:239, kept), so it agrees
    to float32's 2^-24."""
    nx = 24
    kw = dict(coarsen_type="pmis", interp_type="classical", P_max_elmts=4,
              relax_down=18, relax_up=18, lattice_shape=(nx, nx, nx),
              dtype="float64")
    dev = BoomerAMG(laplacian_7pt(nx, nx, nx),
                    BoomerAMGOptions(**kw, device_rap=True), device="cpu")
    host = BoomerAMG(laplacian_7pt(nx, nx, nx),
                     BoomerAMGOptions(**kw, device_rap=False), device="cpu")
    A, H = dev.levels[1].A, host.levels[1].A
    assert A.offsets == H.offsets
    d, h = A.data.numpy(), H.data.numpy()
    k0 = A.offsets.index(0)
    scale = np.abs(h).max()
    off = np.delete(np.abs(d - h), k0, axis=0)
    assert off.max() <= 1e-12 * scale
    ho = np.delete(h, k0, axis=0)
    nz = ho != 0
    assert (off[nz] / np.abs(ho[nz])).max() <= 1e-12
    assert off[~nz].max() <= 8 * 2.0**-52 * scale
    rel = np.abs(d[k0] - h[k0]) / np.where(h[k0] == 0, 1.0, np.abs(h[k0]))
    assert rel.max() <= 2.0**-24
    assert np.array_equal(dev.levels[0].R.data.numpy(), host.levels[0].R.data.numpy())
