"""K1's share of its roofline (%): the sum of the least times of the
traced window's dcn_fwd launches over their device time, its channels-last
prologue included."""
from benchmark import roofline


def read(trace):
    return roofline.roofline_pct(trace, ("dcn_fwd",))
