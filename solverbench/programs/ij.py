"""hypre's `ij` driver line on the port: `hypre_tpu_torch.drivers.ij.run`
builds the matrix, the BoomerAMG hierarchy and the frozen fine operator
and runs one solve; the window then calls the Krylov function the
driver calls for the line's solver id, with the driver's operator
`spmv(op, x)` and `M = amg.precond`.

The configuration names what varies by line: `model`, the function of
`hypre_tpu_torch.models` the driver builds the matrix with (timed as
`problem_s`), and `krylov`: `call` and `options`, a function and its
options class of `hypre_tpu_torch.solvers.krylov`, with `kwargs`.  The
relaxation the configuration states (`amg.relax`) is held against the
one the driver chose.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time

import torch


class Program:
    """The system under test as set-up left it: `solve(b)` is the
    window's call; `release()` hands over the host hierarchy and drops
    the device state."""

    def __init__(self, res, config: dict):
        from hypre_tpu_torch.ops.dia import spmv
        from hypre_tpu_torch.solvers import krylov

        amg, op = res.amg, res.op
        relax = (amg.opts.relax_down, amg.opts.relax_up)
        if relax != tuple(config["amg"]["relax"]):
            raise RuntimeError(
                f"the program relaxes with {relax[0]} / {relax[1]}, the "
                f"configuration states {config['amg']['relax']}")
        k = config["krylov"]
        call = getattr(krylov, k["call"])
        opts = getattr(krylov, k["options"])(**k["kwargs"])
        matvec = lambda x: spmv(op, x)  # noqa: E731
        self._call = lambda b: call(matvec, b, M=amg.precond, opts=opts)
        self.amg = amg
        self.n = op.num_rows

    def solve(self, b):
        """(x, iterations, converged) of one solve."""
        res = self._call(b)
        return res.x, int(res.num_iterations), bool(res.converged)

    def host_state(self) -> dict:
        """The set-up's host hierarchy: operators, interpolations and C / F
        markers by level."""
        amg = self.amg
        if any(P is None for P in amg._host_P):
            raise RuntimeError("a level's interpolation stayed on the device; "
                               "the check reads the host hierarchy")
        return {"A": list(amg._host_A), "P": list(amg._host_P),
                "cf": list(amg._cf)}

    def release(self) -> dict:
        """host_state(), and the device state dropped."""
        state = self.host_state()
        self.amg = self._call = None
        return state


@contextlib.contextmanager
def timed_attr(module_name: str, attr: str, into: dict, key: str):
    """Add the host seconds of every call of module.attr to into[key]."""
    module = importlib.import_module(module_name)
    orig = getattr(module, attr)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(*args, **kwargs)
        finally:
            into[key] = into.get(key, 0.0) + time.perf_counter() - t0

    setattr(module, attr, wrapper)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def setup(config: dict, device):
    """(Program, {problem_s, amg_setup_s, freeze_s}) of the line."""
    from hypre_tpu_torch.drivers import ij
    from hypre_tpu_torch.utils.timing import GLOBAL_TIMER

    phases: dict = {"problem_s": 0.0}
    GLOBAL_TIMER.clear()
    with timed_attr("hypre_tpu_torch.models", config["model"], phases,
                    "problem_s"), contextlib.redirect_stdout(sys.stderr):
        res = ij.run(list(config["line"]), device=str(device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    if res.amg is None or not bool(res.converged):
        raise RuntimeError("the driver's own solve did not converge")
    phases["amg_setup_s"] = GLOBAL_TIMER.seconds("SETUP")
    phases["freeze_s"] = (GLOBAL_TIMER.seconds("FREEZE")
                          + GLOBAL_TIMER.seconds("COLLAPSE"))
    return Program(res, config), phases
