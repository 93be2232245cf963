"""The whole unit's share (%) of the card's peak: the plain reference's
FLOPs of the traced window's units (a clip, a meta update with its second
order, a push) over its seconds times the dtype's peak (67 TFLOP/s fp32,
989 bf16). Reads `mfu.serve`, `mfu.train` and `mfu.stream`."""
from benchmark import roofline


def read(trace):
    return roofline.mfu_pct(trace)
