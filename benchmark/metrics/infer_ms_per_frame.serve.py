"""Milliseconds of inference a delivered frame: the spans around
adapt/adaptation.py chunked_apply (the adapted net over every window of
the clip), over the frames the traced window delivered."""
from benchmark.trace import Trace


def read(trace: Trace):
    s, n = trace.span_s("infer"), trace.counters.get("frames", 0)
    return 1e3 * sum(s) / n if s and n else None
