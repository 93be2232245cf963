"""Share (%) of the traced window in which no kernel, copy or memset ran
on the device. Reads `device_idle_pct.serve`, `.train` and `.stream`."""
from benchmark.trace import Trace


def read(trace: Trace):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
