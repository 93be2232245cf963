"""The DCN kernels' share of their roofline (%) over a meta update's
launches: K1-K3 and the second-order K8-K10, helper kernels included."""
from benchmark import roofline

KERNELS = ("dcn_fwd", "dcn_bwd_data", "dcn_bwd_weight", "dcn_fwd_tangent",
           "dcn_bwd_weight_tangent", "dcn_bwd_data_tangent")


def read(trace):
    return roofline.roofline_pct(trace, KERNELS)
