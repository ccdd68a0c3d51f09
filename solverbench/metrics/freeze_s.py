"""freeze_s: GLOBAL_TIMER's FREEZE + COLLAPSE phases (the frozen
levels, lattice builds, device RAP, GS schedules, coarse collapse)."""


def read(run):
    return run.setup["freeze_s"]
