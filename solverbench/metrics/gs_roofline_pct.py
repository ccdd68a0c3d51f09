"""gs_roofline_pct: the needed bytes of the traced solves' gs launches
(counts/gs.py) at the card's published HBM bandwidth, over those
launches' device time, in percent."""

from ._common import roofline_pct


def read(run):
    return roofline_pct(run, "gs")
