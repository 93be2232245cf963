"""Mean host milliseconds a push takes until MultiStreamSR.push returns,
before any synchronise: the streaming layer's enqueue time (ring writes,
feature extraction and fusion launched, emission bookkeeping)."""
from benchmark.trace import Trace


def read(trace: Trace):
    s = trace.span_s("push_host")
    return 1e3 * sum(s) / len(s) if s else None
