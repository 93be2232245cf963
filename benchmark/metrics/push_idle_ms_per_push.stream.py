"""Device idle milliseconds a push inside the program's span `stream.push`
(eval/streaming.py: the frames up, the pyramid ingest, the due windows'
fusion); the pacing sleep between pushes lies outside it."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    return pt.idle_ms_per_unit(trace, "stream.push")
