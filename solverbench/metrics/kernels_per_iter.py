"""kernels_per_iter: the device operations the profiler saw in the
traced solves (kernels, copies, fills) over their iterations."""

from ._common import per_iteration


def read(run):
    tr = run.trace
    return None if tr is None or not tr.events else per_iteration(
        run, len(tr.events))
