"""MB a clip that the program copies between host and device, by its
counters: `h2d_bytes` (the adaptation and inference windows up) and
`d2h_bytes` (the SR frames and the adaptation losses down)."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    n = trace.counters.get("units", 0)
    b = pt.counter(trace, "h2d_bytes") + pt.counter(trace, "d2h_bytes")
    return b / 1e6 / n if n and b else None
