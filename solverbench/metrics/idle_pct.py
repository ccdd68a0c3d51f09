"""idle_pct: the share of the traced wall time in which no device
operation runs (100 - the union of their intervals over the wall)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.events or tr.wall_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.wall_s)
