"""The port's streaming server (eval/streaming.py) on CPU: every case of the
JAX package's tests/test_streaming.py, held against the port's own offline
path, two cases held against the JAX package's streamers, and the kernel
launches of a stream.

The offline path is the window-batched forward over data/windows.
all_windows (EDVR.forward; models/padding.make_model_apply for TOF and
DUF), and for adapt-then-serve cli/test_dynavsr.run_clip on the same first
K windows. Nets are tiny (EDVR nf 8, 3 frames, Gd 2, 1 + 1 blocks; MFDN nf
8; DUF-16L with one dense-1 layer; TOFlow on 3 frames of 8x8 LR), frames
are numpy draws from a seed, torch's weights come from torch.manual_seed
(the JAX cases carry them into JAX params with the JAX package's `.pth`
importer, convert/torch_import.convert_state_dict). Tolerances are stated per
test: 2e-5 where the port holds the stream against its own offline
forward (the same math in other batch shapes), 1e-4 with adaptation.
"""

import collections

import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, run_clip
from dynavsr_tpu_torch.data.windows import all_windows, index_generation
from dynavsr_tpu_torch.eval.streaming import (
    MultiStreamSR,
    StreamingSR,
    WindowStreamSR,
    make_streaming_adapter,
)
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
from dynavsr_tpu_torch.models.tof import TOFlow
from torch_one_thread import one_thread  # noqa: F401

TINY = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
PADDINGS = ["reflection", "replicate", "reflection_circle", "circle", "new_info"]
CFG = AdaptConfig(n_steps=2, lr=1e-4)


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _edvr(seed=1):
    torch.manual_seed(seed)
    model = EDVR(**TINY)
    with torch.no_grad():  # offsets off zero: the DCNs sample off the grid
        for name, p in model.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
    return model.eval()


def _estimator(n=3):
    torch.manual_seed(9)
    return build_estimator({"nf": 8}, 4, n, device="cpu")


def _run(stream, frames):
    """Every (index, SR) a stream emits over `frames` and its flush."""
    got = []
    for f in frames:
        got.extend(stream.push(f))
    got.extend(stream.flush())
    return got


def _stacked(got, t, axis=0):
    assert [i for i, _ in got] == list(range(t))
    return np.stack([sr.numpy() for _, sr in got], axis=axis)


def _offline(model, frames, n, padding, apply=None):
    with torch.no_grad():
        win = torch.tensor(frames[all_windows(len(frames), n, padding)])
        return (apply(model, win) if apply else model(win)).numpy()


def _adapted_offline(model, est, frames, n, k, padding, **kw):
    """run_clip: the same adaptation on the first k windows, then every
    window window-batched."""
    sr, res = run_clip(model, est, frames, None, CFG, seq=False, n_frames=n, padding=padding,
                       n_adapt=k, device="cpu", **kw)
    return sr, np.asarray(res["adapt_losses"])


def _edvr_adapter(est, batched=False):
    return make_streaming_adapter(CFG, est, apply_fn=make_model_apply("EDVR", 4),
                                  batched=batched)


@pytest.mark.parametrize("padding", PADDINGS)
def test_streaming_matches_offline(padding):
    """Every padding: the streamed frames equal EDVR.forward over all
    windows (2e-5)."""
    model, frames = _edvr(), _frames((7, 8, 8, 3), 7)
    got = _stacked(_run(StreamingSR(model, n_frames=3, padding=padding), frames), 7)
    np.testing.assert_allclose(got, _offline(model, frames, 3, padding), atol=2e-5)


def test_streaming_latency_reflection():
    """reflection: frame i emits as soon as frame i + N//2 arrives."""
    model, frames = _edvr(), _frames((6, 8, 8, 3), 7)
    stream = StreamingSR(model, n_frames=3, padding="reflection")
    emitted_at = {}
    for step, f in enumerate(frames):
        for i, _ in stream.push(f):
            emitted_at[i] = step
    tail = [i for i, _ in stream.flush()]
    assert emitted_at == {0: 1, 1: 2, 2: 3, 3: 4, 4: 5}
    assert tail == [5]


def test_streaming_buffer_stays_bounded():
    """The ring is allocated once at 2N arrival slots and never grows; the
    SR frames it emits do not alias it; flush resets the stream."""
    model, frames = _edvr(), _frames((7, 8, 8, 3), 7)
    stream = StreamingSR(model, n_frames=3)
    rings = None
    for f in frames:
        for _, sr in stream.push(f):
            ptrs = {r.untyped_storage().data_ptr() for r in [*stream._rings[0], stream._rings[1]]}
            assert sr.untyped_storage().data_ptr() not in ptrs
        leaves = [*stream._rings[0], stream._rings[1]]
        assert len(leaves) == 4 and all(r.shape[0] == 6 for r in leaves)
        if rings is None:
            rings = [r.data_ptr() for r in leaves]
        assert [r.data_ptr() for r in leaves] == rings  # written in place
    stream.flush()
    assert stream._t == 0 and stream._rings is None


def test_streaming_with_adaptation_matches_offline():
    """StreamingSR with the MFDN adapter on K = 2 windows equals run_clip
    (adapted on the same windows, window-batched): SR 1e-4, losses 1e-5
    relative; reset restores the unadapted module."""
    model, frames, est = _edvr(), _frames((7, 16, 16, 3), 7), _estimator()
    sr_off, losses_off = _adapted_offline(model, est, frames, 3, 2, "reflection")
    stream = StreamingSR(model, n_frames=3, adapter=_edvr_adapter(est), adapt_windows=2)
    got = _stacked(_run(stream, frames), 7)
    np.testing.assert_allclose(got, sr_off, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stream.adapt_losses.numpy(), losses_off, rtol=1e-5)
    assert stream._t == 0 and not stream._adapted and stream.models == [model]


@pytest.mark.parametrize("padding", ["reflection_circle", "new_info", "circle", "replicate"])
def test_streaming_adaptation_matches_offline_all_paddings(padding):
    """The warm-up waits for every frame the first K windows reference
    (circle-type paddings borrow up to 2*(N//2) ahead of a start window's
    centre): K = 1 with N = 3 makes window 0 reach frame 2."""
    model, frames, est = _edvr(), _frames((7, 16, 16, 3), 8), _estimator()
    sr_off, losses_off = _adapted_offline(model, est, frames, 3, 1, padding)
    stream = StreamingSR(model, n_frames=3, padding=padding, adapter=_edvr_adapter(est),
                         adapt_windows=1)
    got = _stacked(_run(stream, frames), 7)
    np.testing.assert_allclose(got, sr_off, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stream.adapt_losses.numpy(), losses_off, rtol=1e-5)


def test_stacked_params_with_adapter_rejected():
    """Per-group modules with an adapter are a contradiction (the warm-up
    starts every group from one module): rejected at construction."""
    model, est = _edvr(), _estimator()
    with pytest.raises(ValueError, match="mutually exclusive"):
        MultiStreamSR([model, model], n_streams=2, n_frames=3,
                      adapter=_edvr_adapter(est, batched=True), adapt_windows=1)


def test_streaming_adaptation_short_clip_clamps():
    """A stream shorter than the warm-up adapts on min(K, T) windows of its
    true length at flush: run_clip's n_adapt clamp."""
    model, frames, est = _edvr(), _frames((3, 16, 16, 3), 9), _estimator()
    sr_off, _ = _adapted_offline(model, est, frames, 3, 3, "reflection")
    stream = StreamingSR(model, n_frames=3, adapter=_edvr_adapter(est), adapt_windows=8)
    got = []
    for f in frames:
        got.extend(stream.push(f))
    assert got == []  # nothing emitted mid-warm-up
    np.testing.assert_allclose(_stacked(stream.flush(), 3), sr_off, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------- the window streamer
def _tof():
    torch.manual_seed(2)
    return TOFlow(nframes=3).eval()


def _duf():
    torch.manual_seed(3)
    return DUF(scale=4, dense1_layers=1).eval()


def test_window_stream_tof_matches_offline():
    """TOF served online equals the window-batched padded forward (bicubic
    pre-upscale, mod-8), 2e-5."""
    model, frames = _tof(), _frames((6, 8, 8, 3), 21)
    got = _stacked(_run(WindowStreamSR(model, n_frames=3, padding="reflection"), frames), 6)
    want = _offline(model, frames, 3, "reflection", make_model_apply("TOF", 4))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_window_stream_duf_matches_offline():
    model, frames = _duf(), _frames((9, 8, 8, 3), 22)
    got = _stacked(_run(WindowStreamSR(model, n_frames=7, padding="replicate"), frames), 9)
    want = _offline(model, frames, 7, "replicate", make_model_apply("DUF", 4))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("which", ["TOF", "DUF"])
def test_window_stream_adaptation_matches_offline(which):
    """Adapt-then-serve through the window streamer with train_ema
    BatchNorm (the adapter takes the padded and the train-mode forwards):
    equal to run_clip, SR 1e-4, losses 1e-5 relative."""
    n, pad = (3, "reflection") if which == "TOF" else (7, "replicate")
    model = _tof() if which == "TOF" else _duf()
    frames, est = _frames((9, 16, 16, 3), 23), _estimator(n)
    sr_off, losses_off = _adapted_offline(model, est, frames, n, 2, pad)
    adapter = make_streaming_adapter(CFG, est, apply_fn=make_model_apply(which, 4),
                                     mutable_apply_fn=make_mutable_model_apply(which, 4))
    stream = WindowStreamSR(model, n_frames=n, padding=pad, adapter=adapter, adapt_windows=2)
    got = _stacked(_run(stream, frames), 9)
    np.testing.assert_allclose(got, sr_off, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stream.adapt_losses.numpy(), losses_off, rtol=1e-5)


# ------------------------------------------------------------ multi-stream
def _single(model, clip, n=3):
    return _stacked(_run(StreamingSR(model, n_frames=n), clip), len(clip))


def _multi(ms, clips):
    got = []
    for i in range(clips.shape[1]):
        got.extend(ms.push(clips[:, i]))
    got.extend(ms.flush())
    return _stacked(got, clips.shape[1], axis=1)  # (B, T, ...)


def test_multi_stream_lockstep_matches_single():
    """MultiStreamSR with one shared module == B independent streams."""
    model, clips = _edvr(), _frames((3, 6, 8, 8, 3), 11)
    got = _multi(MultiStreamSR(model, n_streams=3, n_frames=3), clips)
    for s in range(3):
        np.testing.assert_allclose(got[s], _single(model, clips[s]), atol=2e-5)


def test_multi_stream_per_stream_params(monkeypatch):
    """One module a stream: each stream is served by its own net, and its
    DCNs get contiguous tensors, as the kernels require (a one-stream
    block of the gathered (B, N, ...) window is a strided view)."""
    from dynavsr_tpu_torch.models import edvr as edvr_module

    plain = edvr_module.deform_conv2d

    def contiguous_only(x, offset, mask, weight, bias=None, deformable_groups=1):
        assert x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)
        assert offset.is_contiguous() and mask.is_contiguous()
        return plain(x, offset, mask, weight, bias, deformable_groups=deformable_groups)

    monkeypatch.setattr(edvr_module, "deform_conv2d", contiguous_only)
    nets, clips = [_edvr(1), _edvr(99)], _frames((2, 5, 8, 8, 3), 12)
    got = _multi(MultiStreamSR(nets, n_streams=2, n_frames=3), clips)
    for s, net in enumerate(nets):
        np.testing.assert_allclose(got[s], _single(net, clips[s]), rtol=2e-5, atol=2e-5)


def test_multi_stream_adaptation_per_stream():
    """Batched adapter, one group a stream: each stream equals a single
    adapted stream on its own windows."""
    model, clips, est = _edvr(), _frames((2, 6, 16, 16, 3), 13), _estimator()
    ms = MultiStreamSR(model, n_streams=2, n_frames=3,
                       adapter=_edvr_adapter(est, batched=True), adapt_windows=2)
    got = _multi(ms, clips)
    assert tuple(ms.adapt_losses.shape) == (2, CFG.n_steps)
    for s in range(2):
        single = StreamingSR(model, n_frames=3, adapter=_edvr_adapter(est), adapt_windows=2)
        want = _stacked(_run(single, clips[s]), 6)
        np.testing.assert_allclose(got[s], want, rtol=1e-4, atol=1e-4)


def _pooled(clips, streams, k, n=3):
    """The explicit pooled task: the group's streams' first-k window
    stacks, concatenated in stream order."""
    idx = [index_generation(j, 1 << 30, n, "reflection") for j in range(k)]
    return torch.tensor(np.concatenate([np.stack([clips[s][ix] for ix in idx])
                                        for s in streams]))


def test_multi_stream_grouped_adaptation():
    """n_groups G: consecutive blocks of B/G streams share one copy adapted
    on the pooled first-K windows of the block, equal to the explicit
    construction (the unbatched adapter once a group, each stream then
    served by the group's copy)."""
    model, clips, est = _edvr(), _frames((4, 6, 16, 16, 3), 14), _estimator()
    ms = MultiStreamSR(model, n_streams=4, n_frames=3, n_groups=2,
                       adapter=_edvr_adapter(est, batched=True), adapt_windows=2)
    got = _multi(ms, clips)
    assert tuple(ms.adapt_losses.shape) == (2, CFG.n_steps)
    adapter1 = _edvr_adapter(est)
    for gi in range(2):
        streams = range(2 * gi, 2 * gi + 2)
        adapted, _ = adapter1(model, _pooled(clips, streams, 2))
        for s in streams:
            np.testing.assert_allclose(got[s], _single(adapted, clips[s]), rtol=1e-4,
                                       atol=1e-4)


def test_multi_stream_grouped_stacked_params():
    """G modules without an adapter: each block of B/G streams is served by
    its group's net."""
    nets, clips = [_edvr(1), _edvr(98)], _frames((4, 5, 8, 8, 3), 15)
    got = _multi(MultiStreamSR(nets, n_streams=4, n_frames=3, n_groups=2), clips)
    for s, net in zip(range(4), [nets[0], nets[0], nets[1], nets[1]]):
        np.testing.assert_allclose(got[s], _single(net, clips[s]), rtol=2e-5, atol=2e-5)


def test_multi_stream_single_group_takes_plain_path():
    """n_groups 1 is the shared path, with one module given or after a
    batched warm-up: the output equals the shared streamer's bitwise."""
    model, clips, est = _edvr(), _frames((2, 5, 16, 16, 3), 16), _estimator()
    ms = MultiStreamSR([model], n_streams=2, n_frames=3, n_groups=1)
    assert ms._g == 0
    got = _multi(ms, clips)
    np.testing.assert_array_equal(got, _multi(MultiStreamSR(model, n_streams=2, n_frames=3),
                                              clips))
    ms_a = MultiStreamSR(model, n_streams=2, n_frames=3, n_groups=1, adapt_windows=2,
                         adapter=make_streaming_adapter(AdaptConfig(n_steps=1, lr=1e-4), est,
                                                        batched=True))
    for i in range(5):
        ms_a.push(clips[:, i])
    assert ms_a._g == 0 and len(ms_a.models) == 1
    ms_a.flush()


def test_multi_stream_groups_must_divide():
    model = _edvr()
    with pytest.raises(ValueError, match="divide"):
        MultiStreamSR([model] * 3, n_streams=4, n_frames=3, n_groups=3)


# ------------------------------------------------------------ the launches
def _counted(monkeypatch, op):
    """The kernel Functions with plain stand-ins for their launchers
    (test_torch_port_double_backward.py's), each launcher call counted."""
    from dynavsr_tpu_torch.models import duf as duf_module
    from dynavsr_tpu_torch.models import edvr as edvr_module
    from dynavsr_tpu_torch.models import tof as tof_module
    from dynavsr_tpu_torch.ops import dcn, duf_filter
    from dynavsr_tpu_torch.ops import grid_sample as warp
    from test_torch_port_double_backward import _stand_ins

    _stand_ins(op, monkeypatch)
    calls = collections.Counter()
    module, names = {"dcn": (dcn, {"_fwd": "dcn_fwd", "dcn_bwd_data": "dcn_bwd_data",
                                   "dcn_bwd_weight": "dcn_bwd_weight"}),
                     "warp": (warp, {"warp_fwd": "warp_fwd", "warp_bwd": "warp_bwd"}),
                     "duf": (duf_filter, {"duf_fwd": "duf_fwd", "duf_bwd": "duf_bwd"})}[op]
    for name, kernel in names.items():
        def counted(*args, fn=getattr(module, name), kernel=kernel, **kwargs):
            calls[kernel] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    if op == "dcn":
        monkeypatch.setattr(edvr_module, "deform_conv2d",
                            lambda x, o, m, w, b=None, deformable_groups=1:
                            dcn.DeformConv2dFunction.apply(x, o, m, w, b, deformable_groups))
    elif op == "warp":
        monkeypatch.setattr(tof_module, "warp_nchw", warp.WarpFunction.apply)
    else:
        monkeypatch.setattr(duf_module, "dynamic_upsampling_filter",
                            duf_filter.DufFilterFunction.apply)
    return calls


@pytest.mark.parametrize("which", ["EDVR", "TOF", "DUF"])
def test_stream_launches_with_the_kernel_stand_ins(which, monkeypatch):
    """Kernel launches of a stream (5 Adam steps on K = 2 windows): EDVR K2
    = K3 = 20 in the warm-up (4 DCNs x 5 backward passes) and K1 = 4 a
    steady push (the 4 DCNs of PCD, once); TOF K5 = 5 x 2 neighbours x 4
    SpyNet levels (the level-0 flow is zeros: no backward) and K4 = 2 x 5 a
    push; DUF K7 = 5 and K6 = 1 a push."""
    op = {"EDVR": "dcn", "TOF": "warp", "DUF": "duf"}[which]
    calls = _counted(monkeypatch, op)
    n = 7 if which == "DUF" else 3
    model = {"EDVR": _edvr, "TOF": _tof, "DUF": _duf}[which]()
    frames, est = _frames((6, 16, 16, 3), 30), _estimator(n)
    cfg = AdaptConfig(n_steps=5, lr=1e-4)
    apply = make_model_apply(which, 4)
    mutable = None if which == "EDVR" else make_mutable_model_apply(which, 4)
    adapter = make_streaming_adapter(cfg, est, apply_fn=apply, mutable_apply_fn=mutable)
    if which == "EDVR":
        stream = StreamingSR(model, n_frames=n, adapter=adapter, adapt_windows=2)
    else:
        stream = WindowStreamSR(model, n_frames=n, adapter=adapter, adapt_windows=2,
                                padding="replicate")
    warm = stream._warm_need
    for f in frames[:warm - 1]:
        assert stream.push(f) == []
    calls.clear()
    replayed = stream.push(frames[warm - 1])
    fwd, bwd = {"dcn": ("dcn_fwd", "dcn_bwd_data"), "warp": ("warp_fwd", "warp_bwd"),
                "duf": ("duf_fwd", "duf_bwd")}[op]
    per_push = {"dcn": 4, "warp": (n - 1) * 5, "duf": 1}[op]
    warm_bwd = {"dcn": 20, "warp": 5 * (n - 1) * 4, "duf": 5}[op]
    assert calls[bwd] == warm_bwd
    if op == "dcn":
        assert calls["dcn_bwd_weight"] == 20
    assert calls[fwd] == 5 * per_push + len(replayed) * per_push
    calls.clear()
    assert len(stream.push(frames[warm])) == 1
    assert dict(calls) == {fwd: per_push}
    stream.flush()


# ------------------------------------------------------- against the JAX package
@pytest.fixture(scope="module")
def jax_edvr():
    """Two of the port's tiny EDVRs (seeds 1 and 5) and its MFDN, carried
    into JAX params by the JAX package's own `.pth` importer
    (convert/torch_import.convert_state_dict) over jax.eval_shape
    templates, which compile nothing."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.convert.torch_import import convert_state_dict
    from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
    from dynavsr_tpu.models.edvr import EDVR as JaxEDVR

    vsr, est = JaxEDVR(**TINY), JaxMFDN(scale=4, nf=8)
    x, key = jnp.zeros((1, 3, 16, 16, 3)), jax.random.PRNGKey(0)

    def carried(module, template):
        return convert_state_dict({k: v.numpy() for k, v in module.state_dict().items()},
                                  template)

    nets, est_t = [_edvr(1), _edvr(5)], _estimator()
    like = jax.eval_shape(vsr.init, key, x)
    return dict(vsr=vsr, params=[carried(n, like) for n in nets], est=est,
                est_p=carried(est_t, jax.eval_shape(est.init, key, x)), nets=nets, est_t=est_t)


def test_streaming_adaptation_matches_jax(jax_edvr):
    """StreamingSR with make_streaming_adapter (MFDN, 2 Adam steps at lr
    1e-3, K = 1) at reflection_circle (window 0 reaches frame 2*(N//2), so
    the warm-up waits for 3 frames, where reflection's waits for 2) against
    the JAX package's: losses 1e-5
    relative; SR within 1e-2 of how far adaptation moved it (Adam's first
    step is lr * sign(grad), so the adapted weights agree to fp32 noise)."""
    import jax.numpy as jnp

    from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
    from dynavsr_tpu.eval.streaming import StreamingSR as JaxStreamingSR
    from dynavsr_tpu.eval.streaming import make_streaming_adapter as jax_adapter

    s, frames = jax_edvr, _frames((6, 16, 16, 3), 40)
    pad = "reflection_circle"
    ja = jax_adapter(s["vsr"], JaxAdaptConfig(n_steps=2, lr=1e-3), s["est"].apply, s["est_p"])
    js = JaxStreamingSR(s["vsr"], s["params"][0], n_frames=3, padding=pad, adapter=ja,
                        adapt_windows=1)
    want = np.stack([np.asarray(sr) for _, sr in _run(js, jnp.asarray(frames))])
    losses_j = np.asarray(js.adapt_losses)

    stream = StreamingSR(s["nets"][0], n_frames=3, padding=pad, adapt_windows=1,
                         adapter=make_streaming_adapter(AdaptConfig(n_steps=2, lr=1e-3),
                                                        s["est_t"]))
    assert stream._warm_need == 3
    got = _stacked(_run(stream, frames), 6)
    np.testing.assert_allclose(stream.adapt_losses.numpy(), losses_j, rtol=1e-5)
    moved = np.abs(want - _offline(s["nets"][0], frames, 3, pad)).max()
    assert moved > 1e-3
    assert np.abs(got - want).max() <= 1e-2 * moved


def test_multi_stream_groups_match_jax(jax_edvr):
    """4 streams in 2 groups, each group served by its own net, against the
    JAX package's MultiStreamSR with (G,)-stacked params (1e-4)."""
    import jax
    import jax.numpy as jnp

    from dynavsr_tpu.eval.streaming import MultiStreamSR as JaxMultiStreamSR

    s, clips = jax_edvr, _frames((4, 5, 8, 8, 3), 41)
    stacked = jax.tree_util.tree_map(lambda a, c: jnp.stack([a, c]), *s["params"])
    jm = JaxMultiStreamSR(s["vsr"], stacked, n_streams=4, n_frames=3, params_stacked=True,
                          n_groups=2)
    got_j = []
    for i in range(5):
        got_j.extend(jm.push(jnp.asarray(clips[:, i])))
    got_j.extend(jm.flush())
    want = np.stack([np.asarray(sr) for _, sr in got_j], axis=1)
    got = _multi(MultiStreamSR(s["nets"], n_streams=4, n_frames=3, n_groups=2), clips)
    np.testing.assert_allclose(got, want, atol=1e-4)
