"""Device idle milliseconds a clip inside the program's span `adaptation`
(adapt/adaptation.py make_adapt_fn's function: the deep copy and the k
Adam steps)."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    return pt.idle_ms_per_unit(trace, "adaptation")
