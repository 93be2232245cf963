"""Device idle milliseconds a clip while the host delivers its SR frames:
inside the program's spans `clip.download` (sr.cpu().numpy()) and
`clip.score` (score_frames' per-frame tensor2img) of cli/test_dynavsr.run_clip."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    return pt.idle_ms_per_unit(trace, "clip.download", "clip.score")
