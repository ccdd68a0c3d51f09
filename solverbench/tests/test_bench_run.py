"""A whole run on the CPU at a small grid (the harness's look for a
card skipped), the result line's schema, the check's control and
planted faults, and the imports of the benchmark's command."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from solverbench import control
from solverbench.harness import (ROOT, check_module, forbidden_modules,
                                 run_cell, setup)
from solverbench.tests._small import small_spec

WORKLOADS = ("laplace7_pcg.repeat_rhs", "laplace27_gmres.repeat_rhs")
SEED = 2**31 + 101


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", (0, 1))
def test_run_result_schema(workload, trace):
    spec = small_spec(workload)
    out = run_cell(spec, SEED, 0.3, bool(trace), device="cpu")
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in (spec["per_layer"] if trace
                                else spec["end_to_end"])}
    got = set(out["metrics"])
    if trace:
        # the device readers find nothing on the CPU and stay silent
        assert got == {"problem_s", "amg_setup_s", "freeze_s", "iterations"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["checks"]) == set(check_module(spec["config"]).NUMBERS)
    json.loads(json.dumps(out))


def _fault(kind):
    def wrap(solve):
        def broken(b):
            x, its, conv = solve(b)
            if kind == "stale":  # the step returns its state (x0 = 0)
                x = torch.zeros_like(x)
            elif kind == "half":  # half of the answer left out
                x = x.clone()
                x[x.numel() // 2:] = 0
            elif kind == "altered":  # one value altered where it is made
                x = x.clone()
                x[x.numel() // 3] *= 1 + 1e-6
            return x, its, conv
        return broken
    return wrap


def _interp_fault(kind, monkeypatch):
    """The program's interpolation weights spoilt where they are made:
    rounded to float32, or one F row's first weight altered by 1e-6."""
    from hypre_tpu_torch.solvers.amg import boomeramg

    orig = boomeramg.truncate_interp

    def spoilt(*args, **kwargs):
        P = orig(*args, **kwargs).tocsr(copy=True)
        if kind == "p_float32":
            P.data = P.data.astype("float32").astype("float64")
        else:
            f_rows = [i for i in range(P.shape[0])
                      if P.indptr[i + 1] - P.indptr[i] > 1]
            P.data[P.indptr[f_rows[len(f_rows) // 2]]] *= 1 + 1e-6
        return P

    monkeypatch.setattr(boomeramg, "truncate_interp", spoilt)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("kind", ("stale", "half", "altered", "cycle",
                                  "p_float32", "p_weight"))
def test_planted_faults_are_not_correct(workload, kind, monkeypatch):
    spec = small_spec(workload)
    if kind.startswith("p_"):
        _interp_fault(kind, monkeypatch)
        wrap = None
    elif kind == "cycle":
        from hypre_tpu_torch.solvers.amg.boomeramg import BoomerAMG

        def wrap(solve):
            # a V-cycle that returns its input: the preconditioner's
            # state left unchanged
            monkeypatch.setattr(BoomerAMG, "cycle",
                                lambda self, f, u=None, levels=None: f)
            return solve
    else:
        wrap = _fault(kind)
    out = run_cell(spec, SEED, 0.3, False, device="cpu", wrap_solve=wrap)
    assert out["correct"] is False, (kind, out["checks"])
    if kind.startswith("p_"):
        gap = out["checks"]["interp_gap"]
        assert gap["value"] > gap["limit"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    """The reference in float32 in the program's place fails the check;
    the program itself passes it, on the same seeds."""
    spec = small_spec(workload)
    check = check_module(spec["config"])
    dev = torch.device("cpu")
    program, _ = setup(spec, dev)
    state = program.host_state()
    ref = check.Reference(spec["config"], state, device=dev)
    ctrl = check.Reference(spec["config"], state, dtype=torch.float32,
                           device=dev)
    limits = spec["config"]["limits"]
    for seed in (SEED, SEED + 1, SEED + 2):
        ok, _ = check.judge(control.program_readings(spec, program, ref, seed,
                                                     dev), limits)
        assert ok
        ok, table = check.judge(control.control_readings(
            spec, state, ref, ctrl, seed, dev), limits)
        assert not ok
        assert table["x_gap"]["value"] > limits["x_gap"]
        assert table["interp_gap"]["value"] > limits["interp_gap"]


def test_whole_top_level_names():
    sys.modules.setdefault("hypre_tpu_torch_fake_probe", sys)
    assert "hypre_tpu_torch_fake_probe" not in forbidden_modules()
    sys.modules.pop("hypre_tpu_torch_fake_probe")


def test_command_imports_no_jax():
    """What the command imports, the port's driver and kernels' modules
    included, has no top-level name jax, jaxlib, flax or hypre_tpu."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import solverbench.run, solverbench.harness, solverbench.trace\n"
        "import solverbench.control, solverbench.programs.ij\n"
        "import solverbench.loops.closed, solverbench.reference.check\n"
        "from solverbench import counts, metrics\n"
        "counts.families()\n"
        "for m in pkgutil.iter_modules(metrics.__path__):\n"
        "    importlib.import_module('solverbench.metrics.' + m.name)\n"
        "import hypre_tpu_torch.drivers.ij, hypre_tpu_torch.ops.dia\n"
        "import hypre_tpu_torch.solvers.krylov, hypre_tpu_torch.solvers.amg.relax\n"
        "from solverbench.harness import forbidden_modules\n"
        "print(forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    found, tops = r.stdout.strip().splitlines()[-2:]
    assert found == "[]"
    assert "hypre_tpu_torch" in tops and "'hypre_tpu'" not in tops
    assert "'jax'" not in tops and "'jaxlib'" not in tops


def test_no_card_no_result():
    """Without a CUDA card the command exits non-zero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    r = subprocess.run([sys.executable, "-m", "solverbench.run", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.cuda
def test_small_run_on_the_card():
    """The whole traced run at a small grid on the card: every per-layer
    reader finds its numbers there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = small_spec(WORKLOADS[1])
    out = run_cell(spec, SEED, 1.0, True, device="cuda:0")
    assert out["correct"] is True, out["checks"]
    assert {"kernels_per_iter", "idle_pct", "gs_ns_per_wavefront"} <= set(
        out["metrics"])
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
