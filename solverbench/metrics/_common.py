"""Arithmetic the readers share."""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "peaks.json")


def hbm_bytes_per_s(kind: str):
    """The published HBM bandwidth of the device, None if not in the
    table."""
    with open(PEAKS) as fh:
        peak = json.load(fh).get(kind)
    return None if peak is None else peak["hbm_bytes_per_s"]


def roofline_pct(run, family: str):
    """100 x (the family's needed bytes at peak bandwidth) / (its device
    time), or None where the trace has no launch of it."""
    tr = run.trace
    if tr is None or tr.launches.get(family, {}).get("count", 0) == 0:
        return None
    seconds = tr.family_seconds(family)
    peak = hbm_bytes_per_s(run.device_kind)
    if seconds is None or peak is None or seconds <= 0:
        return None
    return 100.0 * tr.launches[family]["bytes"] / peak / seconds


def per_iteration(run, value):
    tr = run.trace
    if tr is None or tr.iterations == 0:
        return None
    return value / tr.iterations
