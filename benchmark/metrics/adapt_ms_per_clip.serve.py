"""Mean milliseconds of a clip's adaptation: the span around the k Adam
steps (adapt/adaptation.py make_adapt_fn's function), device synchronised
at both ends."""
from benchmark.trace import Trace


def read(trace: Trace):
    s = trace.span_s("adapt")
    return 1e3 * sum(s) / len(s) if s else None
