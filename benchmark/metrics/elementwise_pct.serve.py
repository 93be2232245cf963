"""Share (%) of the device's busy time in kernels labelled elementwise
(casts, activations, adds of the models' layers)."""
from benchmark import roofline
from benchmark.trace import Trace, label_seconds


def read(trace: Trace):
    busy = trace.busy_s
    if busy <= 0:
        return None
    return 100.0 * label_seconds(trace, roofline.kernel_label, "elementwise") / busy
