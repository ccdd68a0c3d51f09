"""gs_ns_per_wavefront: gs_sweep's device nanoseconds over the
wavefronts its launches swept (counts/gs.py), against its latency
bound of one dependent step a wavefront."""


def read(run):
    tr = run.trace
    if tr is None or tr.launches.get("gs", {}).get("wavefronts", 0) == 0:
        return None
    seconds = tr.family_seconds("gs")
    return None if seconds is None else 1e9 * seconds / tr.launches["gs"][
        "wavefronts"]
