"""setup_s: process start to the first timed solve (host clock)."""


def read(run):
    return run.setup["setup_s"]
