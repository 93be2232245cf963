"""The readers of the program's own spans and counters (program_trace.py
and the six metrics that use it) on hand-built traces, the counters'
carrier through the benchmark's Tracer, and the tiny traced cells, each of
which prints its new metrics and no other cell's (CPU only)."""

import time

import pytest
import torch

from benchmark import harness, program_trace as pt
from benchmark.tests.test_bench_faults import SEED, TINY
from benchmark.trace import Event, Trace, Tracer, idle_gaps
from dynavsr_tpu_torch.utils import observability

NEW = {"deliver_idle_ms_per_clip.serve": "serve", "score_ms_per_clip.serve": "serve",
       "adapt_idle_ms_per_clip.serve": "serve", "copy_mb_per_clip.serve": "serve",
       "meta_idle_ms_per_update.train": "train", "push_idle_ms_per_push.stream": "stream"}
KIND = {"edvr_m.reds4": "serve", "edvr_l.reds4": "serve", "edvr_m.meta_reds": "train",
        "edvr_m.live4_qcif": "stream"}


def _read(metric, trace):
    return harness.load_module(harness.reader_path(metric), "t_" + metric.replace(".", "_")
                               ).read(trace)


def _trace(host, device, units=1):
    return Trace(window_s=1.0, host=[Event(*h) for h in host],
                 device=[Event("k", a, b) for a, b in device], counters={"units": units})


def test_idle_inside_intervals_worked_example():
    """Device busy [10, 30) and [50, 60): inside [0, 40) with [35, 55)
    (merged to [0, 55): 55 us, 20 + 5 busy) 30 us idle; inside [25, 35)
    5; with no device event a span is idle throughout."""
    tr = _trace([], [(10, 20), (15, 30), (50, 60)])
    assert pt.idle_us(tr, [(0, 40), (35, 55)]) == 30
    assert pt.idle_us(tr, [(25, 35)]) == 5
    assert pt.idle_us(tr, [(30, 50)]) == 20
    assert pt.idle_us(tr, []) == 0
    assert pt.idle_us(_trace([], []), [(3, 8)]) == 5


def test_readers_on_a_hand_built_clip():
    """Two clips: each reader divides by the units; a trace without the
    program's annotations (the parent's program) reads nothing."""
    host = [("span:clip", 0, 400), ("span:adaptation", 5, 60), ("span:clip.download", 100, 150),
            ("span:clip.score", 150, 300), ("count:h2d_bytes:1500000", 1, 2),
            ("count:d2h_bytes:2500000", 101, 102), ("count:h2d_bytes_x:9", 2, 3)]
    tr = _trace(host + [(n, a + 1000, b + 1000) for n, a, b in host],
                [(5, 50), (120, 130), (1005, 1050), (1120, 1130)], units=2)
    assert _read("adapt_idle_ms_per_clip.serve", tr) == pytest.approx(10 / 1e3)
    assert _read("deliver_idle_ms_per_clip.serve", tr) == pytest.approx(190 / 1e3)
    assert _read("score_ms_per_clip.serve", tr) == pytest.approx(150 / 1e3)
    assert _read("copy_mb_per_clip.serve", tr) == pytest.approx(4.0)
    bare = _trace([("span:adapt", 0, 10)], [(0, 5)], units=2)
    for metric in NEW:
        assert _read(metric, bare) is None, metric


def test_readers_of_an_update_and_a_push():
    tr = _trace([("span:meta.synth", 0, 10), ("span:meta.step", 10, 110),
                 ("span:meta.inner", 10, 40), ("span:stream.push", 200, 260)],
                [(0, 10), (20, 90), (210, 250)])
    assert _read("meta_idle_ms_per_update.train", tr) == pytest.approx(30 / 1e3)
    assert _read("push_idle_ms_per_push.stream", tr) == pytest.approx(20 / 1e3)


def test_counters_travel_in_the_window_and_stay_in_it():
    """observability.count inside the Tracer's window reaches the Trace
    (its annotation outlives the zero-duration filter); a second window
    starts from nothing."""
    totals = []
    for n in (3, 2):
        tracer = Tracer(sync=False)
        with tracer.window():
            for i in range(n):
                observability.count("h2d_bytes", 1000 + i)
                with observability.span("clip"):
                    torch.ones(4).add_(1)
        tr = tracer.trace
        totals.append((pt.counter(tr, "h2d_bytes"), len(pt.spans(tr, "clip"))))
    assert totals == [(3003, 3), (2001, 2)]
    assert pt.counter(Trace(), "h2d_bytes") == 0


def test_idle_gaps_names_a_gap_by_the_innermost_program_span():
    """A gap inside `clip.score`, itself under the benchmark's span:infer:
    the breakdown names it `clip.score: ...`; outside every span, `window`."""
    tr = _trace([("span:clip", 0, 500), ("span:infer", 1, 400), ("span:clip.score", 5, 315),
                 ("aten::to", 20, 30)], [(0, 10), (310, 320), (600, 610)])
    gaps = idle_gaps(tr)
    assert gaps[0][0].startswith("clip.score: no torch op") and gaps[0][1] == 300e-6
    assert gaps[1][0].startswith("window: ")


def test_idle_by_innermost_program_span_worked_example():
    """Device busy [0, 10), [120, 130), [310, 320), [600, 610): the idle
    [10, 120), [130, 310), [320, 600) is cut at the program's spans and
    each piece given to the innermost; the benchmark's own span:infer (in
    trace.spans) is not the program's, and past `clip` lies "outside"."""
    tr = _trace([("span:clip", 0, 500), ("span:infer", 1, 400),
                 ("span:clip.download", 100, 150), ("span:clip.score", 150, 315),
                 ("aten::to", 20, 30)], [(0, 10), (120, 130), (310, 320), (600, 610)])
    tr.spans["infer"] = [(0.0, 1.0)]
    assert pt.idle_by_span(tr) == {"clip": 270, "clip.score": 160, pt.OUTSIDE: 100,
                                   "clip.download": 40}
    assert list(pt.idle_by_span(tr)) == ["clip", "clip.score", pt.OUTSIDE, "clip.download"]
    assert pt.longest_gaps_by_span(tr, top=2) == [
        (280, {"clip": 180, pt.OUTSIDE: 100}), (180, {"clip.download": 20, "clip.score": 160})]
    assert sum(pt.idle_by_span(tr).values()) == 610 - 40  # all the window's idle, once
    bare = _trace([("aten::to", 20, 30)], [(0, 10), (50, 60)])
    assert pt.idle_by_span(bare) == {pt.OUTSIDE: 40}
    assert pt.idle_by_span(Trace()) == {} and pt.longest_gaps_by_span(Trace()) == []


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", list(KIND))
def test_tiny_traced_cell_prints_its_new_metrics(cell, few_threads):
    out = harness.run_cell(cell, SEED, 0.0, True, "cpu", time.perf_counter(),
                           overrides=TINY[cell])
    got = {m for m in out["metrics"] if m in NEW}
    assert got == {m for m, kind in NEW.items() if kind == KIND[cell]}
    assert all(out["metrics"][m]["value"] >= 0 for m in got)
    if KIND[cell] == "serve":  # the bytes a clip's shapes move
        r = harness.resolve(harness.load_bench(), cell)
        cfg = harness._merge(r["cfg"], TINY[cell]["cfg"])
        c = harness._merge(r["traffic"], TINY[cell]["traffic"])["clip"]
        t, n, px = c["frames"], cfg["network_G"]["nframes"], c["lr_h"] * c["lr_w"] * 3 * 4
        k, s = min(cfg["adapt"]["n_windows"], t), cfg["scale"]
        want = (k * n * px + t * n * px + t * px * s * s + 4 * cfg["adapt"]["n_steps"]) / 1e6
        assert out["metrics"]["copy_mb_per_clip.serve"]["value"] == pytest.approx(want)
