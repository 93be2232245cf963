"""Host milliseconds a clip in the program's span `clip.score`: run_clip's
score_frames (a uint8 frame by tensor2img for each SR frame; PSNR / SSIM
when scored)."""
from benchmark import program_trace as pt
from benchmark.trace import Trace


def read(trace: Trace):
    n = trace.counters.get("units", 0)
    iv = pt.spans(trace, "clip.score")
    return sum(b - a for a, b in iv) / 1e3 / n if n and iv else None
