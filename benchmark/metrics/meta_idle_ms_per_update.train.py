"""Device idle milliseconds an update inside the program's span
`meta.step` (MetaModel.optimize_parameters: the inner steps, the outer
loss, the second-order backward, the optimizer and the metrics' syncs)."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    return pt.idle_ms_per_unit(trace, "meta.step")
