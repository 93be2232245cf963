"""K2 and K3's share of their roofline (%), over the adaptation's
dcn_bwd_data and dcn_bwd_weight launches, their helper kernels included."""
from benchmark import roofline


def read(trace):
    return roofline.roofline_pct(trace, ("dcn_bwd_data", "dcn_bwd_weight"))
