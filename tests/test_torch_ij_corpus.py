"""The port's `ij` driver on the CPU against the JAX package's on the
11 command lines of tests/test_regression_drivers.py::test_ij_jobs_corpus
(TEST_ij/coarsening, interp and solvers .jobs shapes);
tests/torch_ij_runs.py says what is held."""

import pytest

from torch_ij_runs import assert_jax_matches_pin, assert_port_matches_pin
from torch_threads import one_thread  # noqa: F401

CORPUS = [
    "-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -cljp -27pt",
    "-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -ruge -27pt",
    "-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -falgout -27pt",
    "-rhsrand -n 15 15 10 -pmis -27pt",
    "-rhsrand -n 15 15 10 -27pt",
    "-rhsrand -n 15 15 10 -Pmx 0",
    "-rhsrand -n 15 15 10 -interptype 8 -Pmx 0",
    "-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -falgout",
    "-solver 1 -rlx 18 -tol 1e-8 -n 10 10 10",
    "-solver 3 -rlx 18 -tol 1e-8 -n 10 10 10",
    "-solver 9 -rlx 18 -tol 1e-8 -n 10 10 10",
]


@pytest.mark.parametrize("line", CORPUS)
def test_corpus_line_matches_jax_driver(line):
    assert_port_matches_pin(line)


@pytest.mark.slow
@pytest.mark.parametrize("line", CORPUS)
def test_jax_driver_matches_its_pin(line):
    assert_jax_matches_pin(line)
