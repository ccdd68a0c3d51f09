"""solve_p90_ms: the 90th percentile of the window's per-solve times,
each from the call until x is on the card, synchronized
(statistics.quantiles' inclusive method)."""

import statistics


def read(run):
    if len(run.solve_s) < 2:
        return 1e3 * run.solve_s[0] if run.solve_s else None
    return 1e3 * statistics.quantiles(run.solve_s, n=10,
                                      method="inclusive")[8]
