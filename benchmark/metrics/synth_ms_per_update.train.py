"""Mean milliseconds of an update's degradation synthesis: the span around
cli/train.synthesize_meta_batch (kernels, blur-downsample, MFDN in the
loop), device synchronised at both ends."""
from benchmark.trace import Trace


def read(trace: Trace):
    s = trace.span_s("synth")
    return 1e3 * sum(s) / len(s) if s else None
