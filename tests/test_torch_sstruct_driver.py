"""The port's `sstruct` driver (hypre_tpu_torch/drivers/sstruct.py) in its
built-in mode on the CPU against the JAX package's
(hypre_tpu/drivers/sstruct.py).

  * Every solver id on the built-in two-part layout, a 2-D line and an
    anisotropic one, against the JAX driver's numbers on the same line
    (JAX_RUNS, pinned: its count, final relative residual and ||x||_2):
    the same count, the residual within 1e-12 (the printed value is
    ~1e-7; the packages' sums round differently by ~1e-17), ||x||_2 within
    1e-12 relative.  Two lines also run the JAX driver live: x
    elementwise within 1e-12 of max |x|.  The slow tier reruns the JAX
    driver on every pinned line.
  * The JAX driver's quirks, each reproduced: -solver 13 (documented as
    PCG + SysPFMG) and 40 run unpreconditioned PCG, the -solver 19 line;
    -solver 20 is a SystemExit in built-in mode; -solver 3 solves part
    0's (0, 0) block alone; -P / -b fold into the refinement (-r) of an
    -in run.
  * The counts chip_smoke.py's phase 18 holds the card to at 48^3
    (SSTRUCT_JAX) are the JAX driver's (slow: -k jax_count), and the
    port's CPU count at the same line.
"""

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest
import torch

from hypre_tpu.drivers import sstruct as jax_driver
from hypre_tpu_torch.drivers import sstruct as port_driver
from torch_threads import one_thread  # noqa: F401

# line -> (iterations, final relative residual, ||x||_2) of the JAX driver
JAX_RUNS = {
    '-n 6 6 6 -solver 0': (22, 9.90545803471459e-07, 39.786178675531616),
    '-n 6 6 6 -solver 1': (32, 8.725811775322984e-07, 39.786184327508096),
    '-n 6 6 6 -solver 3': (16, 5.131841817514651e-07, 21.87946369006638),
    '-n 6 6 6 -solver 8': (90, 9.312359910622999e-07, 39.78616007064127),
    '-n 6 6 6 -solver 10': (6, 9.899236857458482e-07, 39.78620160679478),
    '-n 6 6 6 -solver 11': (9, 9.794927888497797e-07, 39.78620143972894),
    '-n 6 6 6 -solver 13': (19, 3.523958728080423e-07, 39.78620152248519),
    '-n 6 6 6 -solver 18': (19, 3.5239587280803906e-07, 39.78620152248519),
    '-n 6 6 6 -solver 19': (19, 3.523958728080423e-07, 39.78620152248519),
    '-n 6 6 6 -solver 40': (19, 3.523958728080423e-07, 39.78620152248519),
    '-n 6 6 1 -d 2 -solver 11': (9, 6.439582246576876e-07, 29.78134908752918),
    '-n 7 5 4 -solver 1': (20, 5.197391270350656e-07, 21.677081900445685),
}


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def flat(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().ravel()
    if isinstance(x, (tuple, list)):
        return np.concatenate([flat(v) for v in x])
    return np.asarray(x).ravel()


def run_port(line):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = port_driver.run(line.split(), device="cpu")
    return res, out.getvalue()


def run_jax(line):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = jax_driver.run(line.split())
    return res, out.getvalue()


def assert_pin(res, pin):
    iters, rel, xnorm = pin
    assert int(res.num_iterations) == iters
    assert abs(float(res.rel_residual_norm) - rel) <= 1e-12
    assert abs(np.linalg.norm(flat(res.x)) - xnorm) <= 1e-12 * xnorm


@pytest.mark.parametrize("line", sorted(JAX_RUNS))
def test_line_matches_jax_driver(line):
    res, out = run_port(line)
    assert_pin(res, JAX_RUNS[line])
    lines = out.splitlines()
    assert lines[-2] == f"Iterations = {JAX_RUNS[line][0]}"
    assert lines[-1] == (f"Final Relative Residual Norm = "
                         f"{float(res.rel_residual_norm):e}")


@pytest.mark.parametrize("line", ["-n 6 6 6 -solver 18", "-n 6 6 6 -solver 8"])
def test_line_matches_live_jax_driver(line):
    res, out = run_port(line)
    jres, jout = run_jax(line)
    assert out.splitlines()[0] == jout.splitlines()[0]
    xj = flat([np.asarray(v) for pv in jres.x for v in pv])
    assert np.abs(flat(res.x) - xj).max() <= 1e-12 * np.abs(xj).max()
    assert_pin(jres, JAX_RUNS[line])


def test_solvers_13_and_40_are_the_unpreconditioned_pcg():
    """sstruct.c has no precond branch for 13 (documented as PCG +
    SysPFMG) and the JAX driver keeps 40 as an alias: both run the
    -solver 19 line, bit for bit."""
    x19 = flat(run_port("-n 5 4 3 -solver 19")[0].x)
    for sid in (13, 40):
        res, _ = run_port(f"-n 5 4 3 -solver {sid}")
        assert res.solver is None and np.array_equal(flat(res.x), x19)


def test_solver_20_is_refused_in_builtin_mode():
    with pytest.raises(SystemExit, match="solver 20 not implemented"):
        run_port("-n 4 4 4 -solver 20")
    with pytest.raises(SystemExit, match="solver 20 not implemented"):
        run_jax("-n 4 4 4 -solver 20")


def test_solver_3_solves_part_0_block_alone():
    from hypre_tpu_torch.struct import struct_matvec

    res, _ = run_port("-n 6 5 4 -solver 3")
    assert len(res.x) == 1 and tuple(res.x[0].shape) == (6, 5, 4)
    b = res.b[0][0]
    r = b - struct_matvec(res.A.diag_block(0, 0), res.x[0])
    assert float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b)) < 1e-6


def test_P_and_b_fold_into_the_refinement(tmp_path):
    """sstruct.c:1721: -P and -b scale the index space like -r, in both
    packages (a one-rank run)."""
    text = _chip_smoke().SSTRUCT_INFILES["fac"]
    path = tmp_path / "fac.in"
    path.write_text(text)
    runs = {flag: run_port(f"-in {path} -solver 18 {flag}")[0]
            for flag in ("-r 2 1 1", "-P 2 1 1", "-b 2 1 1")}
    want = flat(runs["-r 2 1 1"].x)
    assert want.size == 2 * 2 * 256
    for res in runs.values():
        assert np.array_equal(flat(res.x), want)
    jres, _ = run_jax(f"-in {path} -solver 18 -P 2 1 1")
    xj = np.asarray(jres.x)
    assert np.abs(want - xj).max() <= 1e-12 * np.abs(xj).max()


def test_main_takes_device_flag(capsys):
    port_driver.main("-n 4 4 4 -solver 18 --device cpu".split())
    out = capsys.readouterr().out.splitlines()
    assert out[-2].startswith("Iterations = ") and out[-1].startswith("Final")


def test_run_reports_setup_and_solve_seconds():
    res, _ = run_port("-n 4 4 4 -solver 11")
    assert res.setup_s > 0 and res.solve_s > 0 and res.solver is not None


@pytest.mark.parametrize("sid", [0, 1, 3, 8, 11, 18, 19])
def test_resolve_repeats_the_drivers_solve(sid):
    """`res.resolve` (what chip_smoke.py times for its medians) is the
    driver's own solve: run again it gives the same count and x bitwise."""
    res, _ = run_port(f"-n 4 3 3 -solver {sid}")
    again = res.resolve()
    assert int(again.num_iterations) == int(res.num_iterations)
    assert np.array_equal(flat(again.x), flat(res.x))


@pytest.mark.slow
@pytest.mark.parametrize("line", sorted(JAX_RUNS))
def test_jax_driver_matches_its_pin(line):
    assert_pin(run_jax(line)[0], JAX_RUNS[line])


@pytest.mark.slow
@pytest.mark.parametrize("label", ["(a)", "(b)", "(c)", "(d)"])
def test_jax_count_is_the_chip_pin(label):
    """The JAX driver's count at 48^3 a part (1-3 min and up to ~5 GB a
    line on a CPU), and the port's on the CPU: the count chip_smoke.py's
    phase 18 holds the card to at that size."""
    line, want = _chip_smoke().SSTRUCT_JAX[label]
    res, _ = run_jax(line)
    assert int(res.num_iterations) == want
    assert int(run_port(line)[0].num_iterations) == want
