"""The JAX package's `ij` driver's printouts (and ||x||_2) on the command
lines of tests/test_torch_ij_driver.py and test_torch_ij_corpus.py, and
the checks that hold the port's driver to them.

The fast tests run the port's driver on the CPU against these pins: the
same lines with the numbers masked, the same iteration count, every
printed number but the final residual equal to 1e-10 relative (so as
printed), the final relative residual within the printout's rounding
(5e-7 relative) plus 1e-14, and ||x||_2 within 1e-12 relative.  One
line of each solver family also runs the JAX driver live in the fast
tier (`assert_port_matches_live_jax`): its printout must be the pin's,
and the port's x must equal its x elementwise to 1e-12 relative to
max |x|.  The slow tests (`-m slow`) rerun the JAX driver on every line
and require its printout bitwise and its ||x||_2 to 1e-12, so the pins
stay the JAX package's.

Why the final residual is not held to 1e-10: the drivers print
||b - A x|| / ||b|| of a converged solve, about 1e-9, and the two
packages' matvecs sum in another order (XLA and torch), so that norm
carries a rounding error of about eps ||A|| ||x|| / ||b|| (measured up
to 2e-16 absolute, 2e-7 relative, at 8^3 and 10^3) while x agrees to
1e-15."""

import contextlib
import functools
import io
import re

import numpy as np

NUM = re.compile(r"[-+]?\d+\.\d+(?:e[-+]\d+)?")
INT = re.compile(r"Iterations = (\d+)")

JAX_RUNS = {
    '-n 8 8 8 -solver 0': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        ' Average Convergence Factor = 0.186815\n'
        'BoomerAMG Iterations = 11\n'
        'Final Relative Residual Norm = 9.672297e-09\n'
        , 53.49344072919763),
    '-n 8 8 8 -solver 1': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'Iterations = 8\n'
        'Final Relative Residual Norm = 7.902641e-10\n'
        , 53.493440786314636),
    '-n 8 8 8 -solver 2': (
        'Iterations = 18\n'
        'Final Relative Residual Norm = 3.923978e-09\n'
        , 53.493440786318196),
    '-n 8 8 8 -solver 3': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'GMRES Iterations = 8\n'
        'Final Relative Residual Norm = 1.152930e-09\n'
        , 53.49344078294988),
    '-n 8 8 8 -solver 4': (
        'GMRES Iterations = 54\n'
        'Final Relative Residual Norm = 7.982371e-09\n'
        , 53.49344057944654),
    '-n 8 8 8 -solver 9': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'BiCGSTAB Iterations = 4\n'
        'Final Relative Residual Norm = 2.972112e-09\n'
        , 53.49344078765243),
    '-n 8 8 8 -solver 10': (
        'BiCGSTAB Iterations = 12\n'
        'Final Relative Residual Norm = 6.282586e-09\n'
        , 53.49344074900221),
    '-n 8 8 8 -solver 16': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'COGMRES Iterations = 8\n'
        'Final Relative Residual Norm = 1.152930e-09\n'
        , 53.49344078294988),
    '-n 8 8 8 -solver 20': (
        'Iterations = 18\n'
        'Final Relative Residual Norm = 3.923978e-09\n'
        , 53.493440786318196),
    '-n 8 8 8 -solver 50': (
        'LGMRES Iterations = 31\n'
        'Final Relative Residual Norm = 7.618350e-09\n'
        , 53.49344072946942),
    '-n 8 8 8 -solver 51': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'LGMRES Iterations = 8\n'
        'Final Relative Residual Norm = 7.749419e-10\n'
        , 53.4934407861358),
    '-n 8 8 8 -solver 60': (
        'FlexGMRES Iterations = 54\n'
        'Final Relative Residual Norm = 7.982371e-09\n'
        , 53.493440579446535),
    '-n 8 8 8 -solver 61': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'FlexGMRES Iterations = 8\n'
        'Final Relative Residual Norm = 1.152930e-09\n'
        , 53.49344078294988),
    '-n 8 8 8 -solver 80 -ilu_type 1': (
        'ILU Iterations = 38\n'
        'Final Relative Residual Norm = 6.646887e-09\n'
        , 53.49344039271614),
    '-n 8 8 8 -solver 81 -ilu_lfil 1': (
        'GMRES Iterations = 9\n'
        'Final Relative Residual Norm = 3.308321e-09\n'
        , 53.49344089090299),
    '-n 8 8 8 -solver 5 -max_iter 20': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.431641\n'
        '                operator = 2.372187\n'
        'Iterations = 20\n'
        'Final Relative Residual Norm = 2.246000e-02\n'
        'hypre error: [Method did not converge] \n'
        , 52.29103222432542),
    '-n 8 8 8 -solver 6 -max_iter 20 -xisone': (
        'Iterations = 20\n'
        'Final Relative Residual Norm = 7.352394e-01\n'
        'hypre error: [Method did not converge] \n'
        , 2.712365039904631),
    '-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -cljp -27pt': (
        ' Coarsening Type = CLJP\n'
        ' Interpolation = classical\n'
        '     Complexity:    grid = 1.222667\n'
        '                operator = 1.419783\n'
        ' Average Convergence Factor = 0.083120\n'
        'BoomerAMG Iterations = 8\n'
        'Final Relative Residual Norm = 2.278435e-09\n'
        , 2.376714804955257),
    '-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -ruge -27pt': (
        ' Coarsening Type = RS\n'
        ' Interpolation = classical\n'
        '     Complexity:    grid = 1.157778\n'
        '                operator = 1.175481\n'
        ' Average Convergence Factor = 0.105189\n'
        'BoomerAMG Iterations = 9\n'
        'Final Relative Residual Norm = 1.576618e-09\n'
        , 2.376714805045321),
    '-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -falgout -27pt': (
        ' Coarsening Type = FALGOUT\n'
        ' Interpolation = classical\n'
        '     Complexity:    grid = 1.157778\n'
        '                operator = 1.175481\n'
        ' Average Convergence Factor = 0.105189\n'
        'BoomerAMG Iterations = 9\n'
        'Final Relative Residual Norm = 1.576618e-09\n'
        , 2.376714805045321),
    '-rhsrand -n 15 15 10 -pmis -27pt': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.104889\n'
        '                operator = 1.163718\n'
        ' Average Convergence Factor = 0.111904\n'
        'BoomerAMG Iterations = 9\n'
        'Final Relative Residual Norm = 2.751750e-09\n'
        , 2.376714803176639),
    '-rhsrand -n 15 15 10 -27pt': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.104889\n'
        '                operator = 1.163718\n'
        ' Average Convergence Factor = 0.111904\n'
        'BoomerAMG Iterations = 9\n'
        'Final Relative Residual Norm = 2.751750e-09\n'
        , 2.376714803176639),
    '-rhsrand -n 15 15 10 -Pmx 0': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.400889\n'
        '                operator = 3.599728\n'
        ' Average Convergence Factor = 0.185173\n'
        'BoomerAMG Iterations = 11\n'
        'Final Relative Residual Norm = 8.777238e-09\n'
        , 16.312579696915318),
    '-rhsrand -n 15 15 10 -interptype 8 -Pmx 0': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = standard\n'
        '     Complexity:    grid = 1.394222\n'
        '                operator = 3.517075\n'
        ' Average Convergence Factor = 0.185300\n'
        'BoomerAMG Iterations = 11\n'
        'Final Relative Residual Norm = 8.843461e-09\n'
        , 16.312579716787894),
    '-rhsrand -n 15 15 10 -interptype 0 -Pmx 0 -falgout': (
        ' Coarsening Type = FALGOUT\n'
        ' Interpolation = classical\n'
        '     Complexity:    grid = 1.600444\n'
        '                operator = 2.590136\n'
        ' Average Convergence Factor = 0.144389\n'
        'BoomerAMG Iterations = 10\n'
        'Final Relative Residual Norm = 3.938575e-09\n'
        , 16.31257974452685),
    '-solver 1 -rlx 18 -tol 1e-8 -n 10 10 10': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.427000\n'
        '                operator = 2.469219\n'
        'Iterations = 12\n'
        'Final Relative Residual Norm = 4.923866e-09\n'
        , 108.7513876113292),
    '-solver 3 -rlx 18 -tol 1e-8 -n 10 10 10': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.427000\n'
        '                operator = 2.469219\n'
        'GMRES Iterations = 12\n'
        'Final Relative Residual Norm = 8.566439e-09\n'
        , 108.75138763849301),
    '-solver 9 -rlx 18 -tol 1e-8 -n 10 10 10': (
        ' Coarsening Type = PMIS\n'
        ' Interpolation = ext+i\n'
        '     Complexity:    grid = 1.427000\n'
        '                operator = 2.469219\n'
        'BiCGSTAB Iterations = 7\n'
        'Final Relative Residual Norm = 3.830316e-10\n'
        , 108.75138760914494),
}


def _capture(run, line: str, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run(line.split(), **kw)
    return res, buf.getvalue()


@functools.lru_cache(maxsize=None)
def _port_run(line: str):
    """The port's driver on the CPU on `line`: (result, printout), run
    once a process (the pinned and the live check share it)."""
    from hypre_tpu_torch.drivers import ij as port_ij

    return _capture(port_ij.run, line, device="cpu")


def assert_port_matches_pin(line: str):
    """The port's driver on the CPU against the JAX driver's pinned run;
    returns (result, printout)."""
    want, xnorm = JAX_RUNS[line]
    res, out = _port_run(line)
    assert NUM.sub("#", out) == NUM.sub("#", want), (out, want)
    assert INT.findall(out) == INT.findall(want)
    assert int(res.num_iterations) == int(INT.findall(want)[-1])
    for lw, lp in zip(want.splitlines(), out.splitlines()):
        for a, b in zip(NUM.findall(lw), NUM.findall(lp)):
            a, b = float(a), float(b)
            if "Final Relative Residual Norm" in lw:
                got = float(res.rel_residual_norm)
                assert abs(got - a) <= 5e-7 * abs(a) + 1e-14, (lw, got)
            else:
                assert abs(b - a) <= 1e-10 * abs(a), (lw, lp)
    got = float(np.linalg.norm(res.x.numpy()))
    assert abs(got - xnorm) <= 1e-12 * xnorm, (got, xnorm)
    return res, out


def assert_jax_matches_pin(line: str):
    """The JAX driver reproduces its pinned run."""
    from hypre_tpu.drivers import ij as jax_ij

    want, xnorm = JAX_RUNS[line]
    res, out = _capture(jax_ij.run, line)
    assert out == want
    got = float(np.linalg.norm(np.asarray(res.x)))
    assert abs(got - xnorm) <= 1e-12 * xnorm


def assert_port_matches_live_jax(line: str):
    """The JAX driver run live on `line` reproduces its pin, and the
    port's driver on the CPU matches both: the pin as
    assert_port_matches_pin holds it, and the JAX run's x elementwise to
    1e-12 relative to max |x|."""
    from hypre_tpu.drivers import ij as jax_ij

    want, _ = JAX_RUNS[line]
    rj, out = _capture(jax_ij.run, line)
    assert out == want, (out, want)
    res, _ = assert_port_matches_pin(line)
    xj = np.asarray(rj.x, dtype=np.float64)
    xp = res.x.numpy()
    assert xp.shape == xj.shape
    assert np.abs(xp - xj).max() <= 1e-12 * np.abs(xj).max()
    return res, out
