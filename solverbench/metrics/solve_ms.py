"""solve_ms: the window's wall time over the solves completed in it."""


def read(run):
    return 1e3 * run.window_s / len(run.solve_s) if run.solve_s else None
