"""The port's `ij` driver (hypre_tpu_torch/drivers/ij.py) on the CPU
against the JAX package's, for every solver id at 8^3
(tests/torch_ij_runs.py says what is held), and `-print`'s files byte
for byte."""

import os

import pytest

from torch_ij_runs import (assert_jax_matches_pin, assert_port_matches_live_jax,
                           assert_port_matches_pin)
from torch_threads import one_thread  # noqa: F401

# CGNR stops at 20 iterations unconverged (the hypre error line)
LINES = {s: f"-n 8 8 8 -solver {s}" for s in (0, 1, 2, 3, 4, 9, 10, 16, 20,
                                               50, 51, 60, 61)}
LINES[5] = "-n 8 8 8 -solver 5 -max_iter 20"
LINES[6] = "-n 8 8 8 -solver 6 -max_iter 20 -xisone"
LINES[80] = "-n 8 8 8 -solver 80 -ilu_type 1"
LINES[81] = "-n 8 8 8 -solver 81 -ilu_lfil 1"


@pytest.mark.parametrize("solver", sorted(LINES))
def test_solver_id_matches_jax_driver(solver):
    res, out = assert_port_matches_pin(LINES[solver])
    if solver in (5, 6):
        assert "hypre error: [Method did not converge]" in out
    else:
        assert res.converged

# one solver id of each family: BoomerAMG, PCG, GMRES, CGNR, BiCGSTAB,
# COGMRES, AMG hybrid, LGMRES, FlexGMRES, ILU-GMRES
FAMILIES = (0, 1, 3, 5, 9, 16, 20, 50, 60, 81)


@pytest.mark.parametrize("solver", FAMILIES)
def test_solver_family_matches_live_jax_driver(solver):
    assert_port_matches_live_jax(LINES[solver])


@pytest.mark.slow
@pytest.mark.parametrize("solver", sorted(LINES))
def test_jax_driver_matches_its_pin(solver):
    assert_jax_matches_pin(LINES[solver])


def test_print_writes_the_jax_drivers_files(tmp_path, monkeypatch):
    from hypre_tpu.drivers import ij as jax_ij
    from hypre_tpu_torch.drivers import ij as port_ij

    files = {}
    for name, run in (("jax", jax_ij.run), ("port", port_ij.run)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        kw = {} if name == "jax" else {"device": "cpu"}
        run("-n 4 4 3 -solver 2 -rhsrand -print".split(), **kw)
        files[name] = {f: open(f, "rb").read() for f in sorted(os.listdir(d))}
    assert sorted(files["port"]) == ["IJ.out.A.00000", "IJ.out.b.00000"]
    assert files["port"] == files["jax"]
