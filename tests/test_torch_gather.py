"""The plain versions of the gather kernels against the TPU gather
probes' own numpy references (scripts/exp_mosaic_gather.py :39, :47,
:57, :81), at the probes' shapes and with inputs drawn as the probes
draw them, bitwise: a gather is exact.  The script itself runs its
probes when imported, so it is not imported here.
"""

import numpy as np
import pytest
import torch

from hypre_tpu_torch.ops.gather_kernel import (
    flat_take_cuda, flat_take_reference, take_along_axis_cuda,
    take_along_axis_reference)


@pytest.fixture
def probe_inputs():
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((64, 512)).astype(np.float32)
    iL = rng.integers(0, 512, size=(64, 512)).astype(np.int32)
    iS = rng.integers(0, 64, size=(64, 512)).astype(np.int32)
    xf = rng.standard_normal(128 * 1024).astype(np.float32)
    iF = rng.integers(0, xf.size, size=(64, 512)).astype(np.int32)
    S, L, G = 512, 512, 8
    xb = rng.standard_normal((S, L)).astype(np.float32)
    ib = rng.integers(0, L, size=(G * S, L)).astype(np.int32)
    return dict(x2=x2, iL=iL, iS=iS, xf=xf, iF=iF, xb=xb, ib=ib, S=S, G=G)


def t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("idx,axis", [("iL", 1), ("iS", 0)],
                         ids=["K2a-lanes", "K2b-sublanes"])
def test_take_along_axis_matches_probe(probe_inputs, idx, axis):
    x, i = probe_inputs["x2"], probe_inputs[idx]
    out = take_along_axis_reference(t(x), t(i), axis).numpy()
    assert np.array_equal(out, np.take_along_axis(x, i, axis=axis))


def test_flat_take_matches_probe(probe_inputs):
    xf, iF = probe_inputs["xf"], probe_inputs["iF"]
    out = flat_take_reference(t(xf), t(iF)).numpy()
    assert out.shape == (64, 512)
    assert np.array_equal(out, xf[iF])


def test_k3_grid_take_matches_probe(probe_inputs):
    """K3: 8 blocks of idx against one resident x block; the probe
    checks block 0 (:81), the tiled numpy form checks all 8."""
    xb, ib, S, G = (probe_inputs[k] for k in ("xb", "ib", "S", "G"))
    out = take_along_axis_reference(t(xb), t(ib), 1).numpy()
    assert out.shape == (G * S, 512)
    assert np.array_equal(out[:S], np.take_along_axis(xb, ib[:S], axis=1))
    assert np.array_equal(out, np.take_along_axis(np.tile(xb, (G, 1)), ib,
                                                  axis=1))


def test_take_along_axis_rejects_untiled_shapes():
    x = torch.zeros(4, 6)
    with pytest.raises(ValueError, match="tile"):
        take_along_axis_reference(x, torch.zeros(6, 6, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="axis"):
        take_along_axis_reference(x, torch.zeros(4, 6, dtype=torch.int32), 2)


def test_cpu_tensors_never_launch_the_gather_kernels(probe_inputs):
    take_along_axis_cuda.launches = flat_take_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        take_along_axis_cuda(t(probe_inputs["x2"]), t(probe_inputs["iL"]), 1)
    with pytest.raises(ValueError, match="CUDA"):
        flat_take_cuda(t(probe_inputs["xf"]), t(probe_inputs["iF"]))
    assert take_along_axis_cuda.launches == flat_take_cuda.launches == 0
