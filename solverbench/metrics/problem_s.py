"""problem_s: host seconds of the driver's matrix build
(`hypre_tpu_torch/models/laplacian.py`), timed around the call."""


def read(run):
    return run.setup["problem_s"]
