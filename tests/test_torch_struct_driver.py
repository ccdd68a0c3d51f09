"""The port's `struct` driver (hypre_tpu_torch/drivers/struct.py) on the
CPU against the JAX package's (hypre_tpu/drivers/struct.py).

  * Every solver id at 8^3, and the relax-2, 2-D and multi-box (-P / -b /
    -np) lines, against the JAX driver's numbers on the same line
    (JAX_RUNS, pinned: its count, final relative residual and ||x||_2):
    the same count, the residual within 1e-12 (the printed value is
    ~1e-7; the two packages' matvecs round differently by ~1e-17),
    ||x||_2 within 1e-12 relative.  Two lines also run the JAX driver
    live: x elementwise within 1e-12 of max |x|.  The slow tier reruns
    the JAX driver on every pinned line.
  * The `[REF]` / `[REF~]` corpus of tests/test_regression_drivers.py
    (the struct jobs of the reference's TEST_struct, and the emptyproc
    lines of tests/test_multibox.py) replayed as numbers: each count
    exactly, the residual within 2e-9 where the pin gives one.
  * The counts chip_smoke.py's phase 17 holds the card to (STRUCT_JAX)
    are the JAX driver's at those sizes (slow: -k jax_count).
"""

import contextlib
import importlib.util
import io
import pathlib

import numpy as np
import pytest

from hypre_tpu.drivers import struct as jax_driver
from hypre_tpu_torch.drivers import struct as port_driver
from torch_threads import one_thread  # noqa: F401

# line -> (iterations, final relative residual, ||x||_2) of the JAX driver
JAX_RUNS = {
    '-n 8 8 8 -solver 0': (5, 7.058771518164184e-08, 53.49343904314764),
    '-n 8 8 8 -solver 1': (14, 8.051490925605135e-07, 53.49343985758114),
    '-n 8 8 8 -solver 2': (10, 2.877369703134217e-07, 53.49343320262474),
    '-n 8 8 8 -solver 3': (14, 8.051490925605135e-07, 53.49343985758114),
    '-n 8 8 8 -solver 4': (14, 8.051490925605135e-07, 53.49343985758114),
    '-n 8 8 8 -solver 8': (200, 3.3400519699470664e-06, 53.493234595579956),
    '-n 8 8 8 -solver 10': (4, 8.751475230170419e-08, 53.49344080607799),
    '-n 8 8 8 -solver 11': (7, 5.283447712846811e-07, 53.49344101174193),
    '-n 8 8 8 -solver 17': (9, 3.902886995406994e-07, 53.49344078637969),
    '-n 8 8 8 -solver 18': (16, 3.0221801669740216e-07, 53.49344078631705),
    '-n 8 8 8 -solver 19': (16, 3.022180166974027e-07, 53.49344078631706),
    '-n 8 8 8 -solver 25': (16, 3.0221801669740216e-07, 53.49344078631705),
    '-n 8 8 8 -solver 30': (4, 8.612373962126422e-08, 53.49344095534257),
    '-n 8 8 8 -solver 31': (8, 2.6606791135477604e-07, 53.493441009956435),
    '-n 8 8 8 -solver 38': (40, 8.649512900629907e-07, 53.49339100588739),
    '-n 8 8 8 -solver 39': (40, 8.649512900786143e-07, 53.49339100588739),
    '-n 8 8 8 -solver 1 -relax 2 -skip 1': (10, 7.259378062485018e-07, 53.49341232298707),
    '-n 10 10 1 -d 2 -solver 0': (5, 1.1859907679900762e-07, 54.53769162381626),
    '-n 4 4 4 -P 2 1 2 -b 1 1 1 -solver 1': (17, 8.940048137249679e-07, 22.745689724240677),
    '-n 4 4 1 -d 2 -P 2 2 1 -solver 1': (11, 9.475117785033741e-07, 29.765883409500926),
    '-n 3 3 3 -P 2 1 2 -b 2 1 1 -np 6 -solver 11': (8, 4.817384804742972e-07, 15.83330929222042),
}


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the struct jobs of tests/test_regression_drivers.py:103-139, as
# chip_smoke.py's phase 17 holds the card to them (STRUCT_REF), and the
# emptyproc lines of tests/test_multibox.py: (line, iterations, residual
# or None)
REF_CORPUS = list(_chip_smoke().STRUCT_REF) + [
    # [REF] TEST_struct/emptyproc.saved (tests/test_multibox.py)
    ("-n 12 12 12 -P 2 1 2 -solver 0 -np 6", 6, None),
    ("-n 6 6 6 -b 2 2 2 -P 2 1 2 -solver 0 -np 7", 6, None),
    ("-n 12 12 12 -P 2 2 1 -solver 1 -np 6", 16, None),
    ("-n 6 6 6 -b 2 2 2 -P 2 2 1 -solver 1 -np 7", 16, None),
]


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
    x = res.x.cpu().numpy() if hasattr(res.x, "cpu") else np.asarray(res.x)
    assert abs(np.linalg.norm(x) - xnorm) <= 1e-12 * xnorm


@pytest.mark.parametrize("line", sorted(JAX_RUNS))
def test_line_matches_jax_driver(line):
    res, out = run_port(line)
    assert_pin(res, JAX_RUNS[line])
    lines = out.splitlines()
    assert lines[-2] == f"Iterations = {JAX_RUNS[line][0]}"
    assert lines[-1].startswith("Final Relative Residual Norm = ")
    if "-P" in line:
        assert res.matvec_err <= 1e-12


@pytest.mark.parametrize("line", ["-n 8 8 8 -solver 17", "-n 8 8 8 -solver 18"])
def test_line_matches_live_jax_driver(line):
    res, out = run_port(line)
    jres, jout = run_jax(line)
    assert out.splitlines()[0] == jout.splitlines()[0]
    xj = np.asarray(jres.x)
    assert np.abs(res.x.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    assert_pin(jres, JAX_RUNS[line])


@pytest.mark.parametrize("line, iters, rel", REF_CORPUS,
                         ids=[c[0] for c in REF_CORPUS])
def test_ref_corpus(line, iters, rel):
    res, _ = run_port(line)
    assert res.converged and int(res.num_iterations) == iters
    if rel is not None:
        assert abs(float(res.rel_residual_norm) - rel) < 2e-9


def test_main_takes_device_flag(capsys):
    port_driver.main("-n 6 6 6 -solver 18 --device cpu".split())
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == "Iterations = 10" and out[-1].startswith("Final Relative")


@pytest.mark.slow
@pytest.mark.parametrize("line", sorted(JAX_RUNS))
def test_jax_driver_matches_its_pin(line):
    assert_pin(run_jax(line)[0], JAX_RUNS[line])


@pytest.mark.slow
@pytest.mark.parametrize("label", ["(a)", "(b)", "(c)", "(d) SMG", "(d) SMG-PCG",
                                   "(e)"])
def test_jax_count_is_the_chip_pin(label):
    """The JAX driver's count at the card's sizes (96^3 PFMG: 1-2 min a
    line on a CPU; 32^3 SparseMSG ~4 min and ~6 GB of captured
    constants): the count chip_smoke.py's phase 17 holds the card to."""
    line, want = _chip_smoke().STRUCT_JAX[label]
    res, _ = run_jax(line)
    assert bool(res.converged) and int(res.num_iterations) == want
