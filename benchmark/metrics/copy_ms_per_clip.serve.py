"""Device milliseconds a clip of host-device copies (Memcpy HtoD and
DtoH events: the clip's windows up, the SR frames down)."""
from benchmark.trace import Trace


def read(trace: Trace):
    n = trace.counters.get("units", 0)
    us = sum(e.us for e in trace.device if "HtoD" in e.name or "DtoH" in e.name)
    return us / 1e3 / n if n and us > 0 else None
