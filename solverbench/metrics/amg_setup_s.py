"""amg_setup_s: BoomerAMG's host setup, GLOBAL_TIMER's SETUP phase
(strength, coarsening, interpolation, RAP)."""


def read(run):
    return run.setup["amg_setup_s"]
