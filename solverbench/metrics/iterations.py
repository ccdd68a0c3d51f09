"""iterations: the mean Krylov iteration count of the window's solves."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
