"""The plain versions of the gather kernels against the TPU gather
probes' own numpy references (scripts/exp_mosaic_gather.py :39, :47,
:57, :81), at the probes' shapes and with inputs drawn as the probes
draw them, bitwise: a gather is exact.  The script itself runs its
probes when imported, so it is not imported here.  Then the tiled
form's launch plans: the tiled plain versions, block by block as a plan
assigns the work, against numpy on ragged, narrow, tall and too-wide
shapes, every output element written once.
"""

import numpy as np
import pytest
import torch

from hypre_tpu_torch.ops.gather_kernel import (
    MAX_SHARED_BYTES, flat_plan, flat_take_cuda, flat_take_reference,
    flat_take_tiled, take_along_axis_cuda, take_along_axis_reference,
    take_along_axis_tiled, take_plan)


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


# -- the tiled form's plans (csrc/gather.cu's default form) -----------------
# (x shape, idx shape, axis, the instance the plan must pick)
TAKE_CASES = {
    "K2a-lanes": ((64, 512), (64, 512), 1, "shared"),
    "K2b-sublanes": ((64, 512), (64, 512), 0, "shared"),
    "K3-grid": ((512, 512), (4096, 512), 1, "shared"),
    "ic1": ((8, 37), (24, 1), 1, "shared"),
    "ic%4=1": ((8, 37), (24, 513), 1, "shared"),
    "ic%4=2": ((8, 38), (16, 6), 1, "shared"),
    "ic%4=3": ((8, 40), (8, 7), 1, "shared"),
    "xr1": ((1, 100), (300, 7), 1, "shared"),
    "ir=1xr": ((16, 64), (16, 64), 1, "shared"),
    "ir=3xr": ((16, 64), (48, 64), 1, "shared"),
    "ir=8xr": ((16, 64), (128, 64), 1, "shared"),
    "few-rows-many-idx": ((2, 512), (600, 512), 1, "shared"),
    "many-short-rows": ((1000, 3), (1000, 5), 1, "shared"),
    "axis0-ic=1xc": ((7, 33), (5, 33), 0, "shared"),
    "axis0-ic=3xc": ((7, 33), (5, 99), 0, "shared"),
    "axis0-ic=2xc-aligned": ((64, 12), (10, 24), 0, "shared"),
    "axis0-ic%4=1": ((9, 5), (4, 5), 0, "shared"),
    "axis0-ic%4=2": ((9, 6), (4, 18), 0, "shared"),
    "axis0-xc1": ((3, 1), (4, 5), 0, "shared"),
    "axis1-row-too-wide": ((1, 60_000), (3, 60_000), 1, "l2"),
    "axis0-strip-too-wide": ((2000, 40), (10, 80), 0, "l2"),
}


def take_inputs(xs, ish, axis, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    i = rng.integers(0, xs[1] if axis == 1 else xs[0], size=ish).astype(np.int32)
    return x, i


def numpy_take(x, i, axis):
    """np.take_along_axis with x tiled as the kernels read it."""
    reps = ((i.shape[0] // x.shape[0], 1) if axis == 1
            else (1, i.shape[1] // x.shape[1]))
    return np.take_along_axis(np.tile(x, reps), i, axis=axis)


@pytest.mark.parametrize("case", TAKE_CASES)
def test_take_plan_tiles_every_output_once(case):
    """The tiled plain version, computed block by block as the plan
    assigns it, is np.take_along_axis bitwise, and writes every output
    element exactly once; the plan's shared memory fits a block."""
    xs, ish, axis, instance = TAKE_CASES[case]
    plan = take_plan(xs, ish, axis)
    assert plan.instance == instance
    assert plan.smem <= MAX_SHARED_BYTES == 232_448
    assert plan.grid[1] <= 65_535
    x, i = take_inputs(xs, ish, axis)
    hits = torch.zeros(i.size, dtype=torch.int64)
    out = take_along_axis_tiled(t(x), t(i), axis, hits).numpy()
    assert np.array_equal(out, numpy_take(x, i, axis))
    assert bool((hits == 1).all())


def test_take_plans_at_the_probes():
    """K3: one x row a block, its 8 idx rows in one block; K2 (b): 32-column
    strips, each staged once a block."""
    k3 = take_plan((512, 512), (4096, 512), 1)
    assert (k3.grid, k3.group, k3.chunk, k3.quads, k3.smem) == (
        (512, 1), 1, 8, 128, 2048)
    k2b = take_plan((64, 512), (64, 512), 0)
    assert (k2b.group, k2b.quads, k2b.smem) == (32, 8, 64 * 32 * 4)
    assert k2b.grid[0] == 16


@pytest.mark.parametrize("xs,ish,axis", [
    ((1, 8), (2**28, 8), 1),  # out of 2^31 elements
    ((2**16, 2**15), (2**16, 2**15), 1),  # x and out of 2^31
    ((8, 1), (2**31, 1), 0),
])
def test_take_plan_refuses_2_31_elements(xs, ish, axis):
    """A plan only: nothing is allocated."""
    with pytest.raises(ValueError, match="2\\^31"):
        take_plan(xs, ish, axis)


def test_take_plan_keeps_the_shape_refusals():
    with pytest.raises(ValueError, match="tile"):
        take_plan((4, 6), (6, 6), 1)
    with pytest.raises(ValueError, match="tile"):
        take_plan((4, 6), (4, 7), 0)
    with pytest.raises(ValueError, match="axis"):
        take_plan((4, 6), (4, 6), 2)
    with pytest.raises(ValueError, match="2-D"):
        take_plan((24,), (4, 6), 1)


@pytest.mark.parametrize("threads,blocks", [
    (None, None), (128, None), (64, None), (None, 132 * 8)])
@pytest.mark.parametrize("n", [32_768, 1_529, 1_731, 7, 1, 0, 1_000_003])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flat_take_plan_tiles_every_output_once(n, dtype, threads, blocks):
    """K2 (c) and the lattice path's shapes (1,529 f64 / 1,731 f32),
    ragged counts; the plan's grid (a thread an element), fewer threads
    a block, and the card's resident grid, where a thread walks several
    elements (lane_sweep.py --gathers's overrides)."""
    rng = np.random.default_rng(n)
    table = rng.standard_normal(131_072).astype(dtype)
    idx = rng.integers(0, table.size, size=n).astype(np.int32)
    plan = flat_plan(n, threads=threads, blocks=blocks)
    assert plan.threads == (threads or 256)
    assert plan.blocks == (blocks or -(-n // plan.threads))
    hits = torch.zeros(n, dtype=torch.int64)
    out = flat_take_tiled(t(table), t(idx), hits, plan=plan).numpy()
    assert np.array_equal(out, table[idx])
    assert bool((hits == 1).all())


def test_flat_plan_refuses_2_31_elements():
    with pytest.raises(ValueError, match="2\\^31"):
        flat_plan(2**31)


def test_gather_wrappers_refuse_an_unknown_form(probe_inputs):
    with pytest.raises(ValueError, match="form"):
        take_along_axis_cuda(t(probe_inputs["x2"]), t(probe_inputs["iL"]), 1,
                             form="rowwise")
    with pytest.raises(ValueError, match="form"):
        flat_take_cuda(t(probe_inputs["xf"]), t(probe_inputs["iF"]),
                       form="rowwise")


@pytest.mark.parametrize("case,kw", [
    ("K2a-lanes", {"span": 128, "spread": 4}),
    ("K2a-lanes", {"span": 64, "spread": 8, "batch": 8}),
    ("K2a-lanes", {"instance": "l2", "span": 128, "spread": 4}),
    ("ic%4=1", {"span": 100, "threads": 32}),
    ("ic%4=1", {"span": 8, "spread": 7}),
    ("ir=3xr", {"span": 4, "batch": 8}),
    ("K2b-sublanes", {"spread": 16}),
    ("K2b-sublanes", {"instance": "l2", "spread": 1, "batch": 1}),
    ("K3-grid", {"spread": 8, "threads": 64}),
])
def test_take_plan_overrides_tile_every_output_once(case, kw):
    """The sweep's overrides (lane_sweep.py --gathers) keep the plan
    exact: every output element written once, bitwise numpy."""
    xs, ish, axis, _ = TAKE_CASES[case]
    plan = take_plan(xs, ish, axis, **kw)
    assert all(getattr(plan, k) == v for k, v in kw.items()
               if k not in ("spread",))
    x, i = take_inputs(xs, ish, axis)
    hits = torch.zeros(i.size, dtype=torch.int64)
    out = take_along_axis_tiled(t(x), t(i), axis, hits, plan=plan).numpy()
    assert np.array_equal(out, numpy_take(x, i, axis))
    assert bool((hits == 1).all())


@pytest.mark.parametrize("kw,match", [
    ({"span": 6}, "span"), ({"instance": "tmem"}, "instance"),
    ({"threads": 48}, "threads"), ({"threads": 256}, "threads"),
    ({"batch": 4}, "batch"), ({"spread": 0}, "spread")])
def test_take_plan_refuses_bad_overrides(kw, match):
    with pytest.raises(ValueError, match=match):
        take_plan((64, 512), (64, 512), 1, **kw)


def test_plans_refuse_a_shared_instance_too_wide_and_foreign_plans():
    with pytest.raises(ValueError, match="instance"):
        take_plan((1, 60_000), (3, 60_000), 1, instance="shared")
    x, i = take_inputs((8, 37), (24, 5), 1)
    with pytest.raises(ValueError, match="plan"):
        take_along_axis_tiled(t(x), t(i), 1,
                              plan=take_plan((8, 37), (16, 5), 1))
    with pytest.raises(ValueError, match="plan"):
        flat_take_tiled(t(x[0]), t(i[0]), plan=flat_plan(6))
    with pytest.raises(ValueError, match="threads"):
        flat_plan(10, threads=48)
    with pytest.raises(ValueError, match="blocks"):
        flat_plan(10, blocks=0)
