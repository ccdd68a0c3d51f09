"""torch_ms_per_iter: device milliseconds an iteration of every
operation that is not one of the port's hand-written kernels (torch's
vector updates, dots, epilogues, copies)."""

from ._common import per_iteration

# name fragments of the port's hand-written kernels (hypre_tpu_torch/csrc)
HAND = ("dia_spmv", "ell_spmv", "gs_sweep", "gs_step_probe", "cell_dense",
        "coo_tail", "flat_take", "take_along_axis")


def read(run):
    tr = run.trace
    if tr is None or not tr.events:
        return None
    us = sum(e - s for name, s, e in tr.events
             if not any(h in name for h in HAND))
    return per_iteration(run, us / 1e3)
