"""The port's own spans and counters (utils/observability.span / count) on
CPU, at tiny sizes (EDVR nf 8, 3 frames, Gd 2, 1 + 1 blocks; MFDN nf 8).

- With no profiler recording, span() is one shared no-op and a whole
  run_clip makes no annotation.
- Under torch.profiler, a run_clip (2 Adam steps, 7 frames) leaves every
  serving span once inside its root `clip` (`adaptation.step` once a
  step), and the counters `h2d_bytes` / `d2h_bytes` add up to the bytes
  the clip's shapes move.
- A MetaModel second-order update leaves `meta.inner`, `meta.outer`,
  `meta.grad`, `meta.optim` and `meta.log` inside `meta.step`; the
  synthesis and the feed lie before it.
- MultiStreamSR leaves one `stream.push` a push, with the upload, ingest
  and emit inside; `adaptation` only in the push that warms up.
- Tracing on or off, the SR frames, the adaptation losses and the meta
  weights are bit for bit the same.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, run_clip
from dynavsr_tpu_torch.cli.train import synthesize_meta_batch
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.eval.streaming import MultiStreamSR, make_streaming_adapter
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.video_base_model import create_model
from dynavsr_tpu_torch.utils import observability
from torch_one_thread import one_thread  # noqa: F401

TINY = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
CFG = AdaptConfig(n_steps=2, lr=1e-4)
N_ADAPT = 2
SERVING = ["clip.slr", "clip.upload", "adaptation", "adaptation.copy", "clip.infer",
           "clip.download", "clip.score"]
META = ["meta.inner", "meta.outer", "meta.grad", "meta.optim", "meta.log"]


def _edvr():
    torch.manual_seed(1)
    return EDVR(**TINY).eval()


def _estimator():
    torch.manual_seed(9)
    return build_estimator({"nf": 8}, 4, 3, device="cpu")


def _clip():
    return np.random.default_rng(7).random((7, 16, 16, 3)).astype(np.float32)


def _run_clip(seq=False):
    return run_clip(_edvr(), _estimator(), _clip(), None, CFG, seq=seq, n_frames=3,
                    padding="reflection", n_adapt=N_ADAPT, device="cpu")


def _profiled(fn):
    """fn()'s result and the host annotations the profile holds, as
    (name, start us, end us) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        out = fn()
    marks = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("span:", "count:"))]
    assert all(b > a for _, a, b in marks), "an annotation of no duration"
    return out, sorted(marks, key=lambda m: m[1])


def _spans(marks, name):
    return [(a, b) for n, a, b in marks if n == "span:" + name]


def _inside(inner, outer):
    return all(any(oa <= a and b <= ob for oa, ob in outer) for a, b in inner)


def _counter(marks, name):
    key = f"count:{name}:"
    return sum(int(n[len(key):]) for n, _, _ in marks if n.startswith(key))


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    """Off, span() hands out the same no-op for every name, and a whole
    clip calls no record_function (so it annotates nothing)."""
    assert not torch.autograd._profiler_enabled()
    assert observability.span("clip") is observability.span("meta.step")
    with observability.span("clip") as inside:
        assert inside is None
    made = []
    monkeypatch.setattr(observability, "record_function", lambda *a: made.append(a))
    observability.count("h2d_bytes", 1)
    _run_clip()
    assert made == []


@pytest.mark.parametrize("seq", [False, True], ids=["windows", "seq"])
def test_run_clip_spans_and_copy_counters(seq):
    (sr, res), marks = _profiled(lambda: _run_clip(seq))
    clip = _spans(marks, "clip")
    assert len(clip) == 1
    for name in SERVING:
        assert len(_spans(marks, name)) == 1, name
        assert _inside(_spans(marks, name), clip), name
    steps = _spans(marks, "adaptation.step")
    assert len(steps) == CFG.n_steps
    assert _inside(steps + _spans(marks, "adaptation.copy"), _spans(marks, "adaptation"))
    assert not _inside(_spans(marks, "adaptation"), _spans(marks, "clip.infer"))
    # Up: the adaptation windows, then every window (or the frames and the
    # window table of the sequence path); down: the SR frames, the losses.
    win = all_windows(7, 3, "reflection")
    lq = _clip()
    up = lq[win[:N_ADAPT]].nbytes + (lq.nbytes + win.size * 8 if seq else lq[win].nbytes)
    assert _counter(marks, "h2d_bytes") == up
    assert _counter(marks, "d2h_bytes") == sr.nbytes + 4 * CFG.n_steps
    assert sr.dtype == np.float32 and len(res["adapt_losses"]) == CFG.n_steps


def _meta_model():
    torch.manual_seed(3)
    opt = {"model": "video_meta", "scale": 4, "is_train": True,
           "network_G": {"which_model_G": "EDVR", **TINY}, "path": {},
           "train": {"lr_G": 1e-4, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                     "maml_lr_alpha": 1e-2, "maml_adapt_iter": 1, "first_order": False,
                     "pixel_criterion": "cb"}}
    return create_model(opt, device="cpu")


def _meta_update(model):
    hr = np.random.default_rng(5).random((2, 3, 80, 80, 3)).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    model.feed_data(synthesize_meta_batch(gen, hr, 4))
    model.optimize_parameters()
    return model


def test_meta_update_spans_nest_in_meta_step():
    model, marks = _profiled(lambda: _meta_update(_meta_model()))
    step = _spans(marks, "meta.step")
    assert len(step) == 1
    for name in META:
        assert len(_spans(marks, name)) == 1, name
        assert _inside(_spans(marks, name), step), name
    for name in ("meta.synth", "meta.feed"):
        (a, b), = _spans(marks, name)
        assert b <= step[0][0], name
    order = [n for n, _, _ in marks if n[5:] in META]
    assert order == ["span:" + n for n in META]
    assert model.log["l_outer"] > 0


def _streams():
    torch.manual_seed(1)
    est = _estimator()
    adapter = make_streaming_adapter(CFG, est, apply_fn=make_model_apply("EDVR", 4),
                                     batched=True)
    return MultiStreamSR(_edvr(), n_streams=2, n_frames=3, adapter=adapter,
                         adapt_windows=N_ADAPT)


def test_multi_stream_spans_and_warm_up_only_once():
    frames = np.random.default_rng(13).random((6, 2, 16, 16, 3)).astype(np.float32)

    def pushes():
        ms = _streams()
        return [ms.push(f) for f in frames], ms._warm_need

    (outs, warm), marks = _profiled(pushes)
    push = _spans(marks, "stream.push")
    assert len(push) == len(frames)
    # The warm-up adapts (each group once) inside the push that completes
    # the buffer, and in no other push.
    adapt = _spans(marks, "adaptation")
    assert len(adapt) == 2 and _inside(adapt, [push[warm - 1]])
    for name in ("stream.upload", "stream.ingest", "stream.emit"):
        got = _spans(marks, name)
        assert got and _inside(got, push), name
        for p in push[warm:]:  # every steady push uploads, ingests and emits
            assert any(p[0] <= a and b <= p[1] for a, b in got), name
    assert sum(len(o) for o in outs) == len(_spans(marks, "stream.emit"))


def _results(unit):
    """What a unit hands back, as numpy arrays and lists: a clip's SR
    frames and losses, a meta update's weights and log, every push's SR
    frames and the warm-up's losses."""
    if unit in ("clip", "seq"):
        sr, res = _run_clip(seq=unit == "seq")
        return [sr, res["adapt_losses"]]
    if unit == "meta":
        model = _meta_update(_meta_model())
        return [v.numpy() for v in model.netG.state_dict().values()] + [model.log]
    frames = np.random.default_rng(13).random((6, 2, 16, 16, 3)).astype(np.float32)
    ms = _streams()
    out = [sr.numpy() for f in frames for _, sr in ms.push(f)]
    return out + [ms.adapt_losses.numpy()]


@pytest.mark.parametrize("unit", ["clip", "seq", "meta", "streams"])
def test_tracing_changes_no_result(unit):
    """Profiled and not, a unit's results are bit for bit equal."""
    off = _results(unit)
    on, _ = _profiled(lambda: _results(unit))
    assert len(on) == len(off)
    for a, b in zip(on, off):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
