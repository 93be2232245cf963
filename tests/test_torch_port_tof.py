"""The port's TOFlow (SpyNet, flow warp, fusion; train-mode BatchNorm) and
its DynaVSR-TOF adaptation against the JAX package's, on CPU.

Weights are the JAX init's (redrawn where stated), carried over with their
batch_stats by convert/from_jax.py:jax_params_to_state_dict; inputs are
numpy draws from a seed. The JAX model runs its space-to-depth conv
schedule (s2d=True, its default) and its plain one (s2d=False); the port
runs plain convs, so the two JAX schedules pin that they compute the same
thing. Tolerances (fp32) are stated per test.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_replicas as tr  # tests/ is on sys.path under pytest rootdir
from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
from dynavsr_tpu.adapt.adaptation import make_adapt_fn as jax_make_adapt_fn
from dynavsr_tpu.adapt.adaptation import chunked_apply as jax_chunked_apply
from dynavsr_tpu.models import padding as jax_padding
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.models.padding import make_mutable_model_apply as jax_mutable_apply
from dynavsr_tpu.models.tof import SpyNet as JaxSpyNet
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu_torch.adapt.adaptation import (
    AdaptConfig,
    make_adapt_and_infer,
    make_adapt_fn,
    resolve_bn_mode,
)
from dynavsr_tpu_torch.cli.test_dynavsr import run_clip
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.arch_util import interpolate_bilinear
from dynavsr_tpu_torch.models.downscaler import MFDN, SFDN
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models import padding
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
from dynavsr_tpu_torch.models.tof import SpyNet, TOFlow
from dynavsr_tpu_torch.train.checkpoint import load_pretrained
from torch_one_thread import one_thread  # noqa: F401

T, H, W = 3, 16, 16


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tof(variables, dtype=None, **kw):
    model = TOFlow(nframes=T, dtype=dtype, **kw)
    model.load_state_dict(jax_params_to_state_dict(variables, model.state_dict()), strict=True)
    return model.eval()


def _stats(variables):
    sd = jax_params_to_state_dict({"batch_stats": variables["batch_stats"],
                                   "params": variables["params"]})
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def variables():
    """JAX TOFlow init with the running statistics moved off 0 / 1, so eval
    mode reads them, and each SpyNet block's last conv scaled up 6x, so the
    flows reach a few pixels and the warps sample off the grid and past the
    border."""
    x = jnp.asarray(_frames((1, T, H, W, 3), 0))
    v = _np(jax.jit(JaxTOFlow().init)(jax.random.PRNGKey(0), x))
    for blk in v["params"]["spynet"].values():
        blk["conv4"]["kernel"] = blk["conv4"]["kernel"] * 6.0
    rng = np.random.default_rng(1)
    for blk in v["batch_stats"]["spynet"].values():
        for bn in blk.values():
            bn["mean"] = (rng.standard_normal(bn["mean"].shape) * 0.1).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return v


def test_interpolate_bilinear_x2_matches_jax_image_resize():
    """SpyNet's x2 flow upsample: F.interpolate(align_corners=False) and
    jax.image.resize('bilinear'); 1e-6 (fp32 rounding)."""
    flow = (np.random.default_rng(2).standard_normal((2, 5, 7, 2)) * 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(flow), (2, 10, 14, 2), method="bilinear")
    ours = interpolate_bilinear(torch.from_numpy(flow).permute(0, 3, 1, 2), 2)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "plain"])
def test_spynet_eval_matches_jax(variables, s2d):
    """The flow of one (ref, nbr) pair; 1e-5 of the largest flow value."""
    ref, nbr = (_frames((2, H, W, 3), s) * 2 - 1 for s in (3, 4))
    spy_vars = {"params": variables["params"]["spynet"],
                "batch_stats": variables["batch_stats"]["spynet"]}
    want = np.asarray(JaxSpyNet(s2d=s2d).apply(spy_vars, jnp.asarray(ref), jnp.asarray(nbr)))
    model = SpyNet()
    model.load_state_dict(jax_params_to_state_dict(spy_vars, model.state_dict()), strict=True)
    with torch.no_grad():
        got = model.eval()(*(torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
                             for a in (ref, nbr)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want).max() > 2.0  # flows of pixels


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "plain"])
def test_tof_eval_forward_matches_jax(variables, s2d):
    """3 frames of 16x16; 1e-5 absolute on outputs of O(1)."""
    x = _frames((2, T, H, W, 3), 5)
    want = np.asarray(jax.jit(JaxTOFlow(s2d=s2d).apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _torch_tof(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, H, W, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want - x[:, T // 2]).max() > 0.1  # the network, not the identity, is held


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "plain"])
def test_tof_train_forward_and_batch_stats_match_jax(variables, s2d):
    """Train mode: batch statistics in the forward, and one EMA step of
    every BN per neighbour (T - 1 = 2 here, 6 at 7 frames). The coarsest
    SpyNet level normalises over 2 frames x 2x2 pixels, which amplifies
    rounding (flax takes the variance as E[x^2] - E[x]^2, the port in two
    passes), so output 5e-5 absolute on O(1) values and running stats 1e-6
    relative. torch's own unbiased update (n / (n - 1) = 8 / 7 there)
    would miss by far more: checked."""
    x = _frames((2, T, H, W, 3), 6)
    train = JaxTOFlow(s2d=s2d, train=True)
    want, upd = jax.jit(lambda v, a: train.apply(v, a, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = _torch_tof(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)
    want_stats = _stats({"params": variables["params"], "batch_stats": _np(upd["batch_stats"])})
    sd = model.state_dict()
    for k, v in want_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    assert int(sd["spynet.block0.bn0.num_batches_tracked"]) == T - 1
    # The same update with torch's own BatchNorm2d (unbiased variance) misses.
    plain = torch.nn.BatchNorm2d(32).train()
    plain.load_state_dict(model.spynet.block0.bn0.state_dict())
    start = {k: torch.tensor(v) for k, v in
             variables["batch_stats"]["spynet"]["block0"]["bn0"].items()}
    probe = torch.randn(2, 32, 2, 2, generator=torch.Generator().manual_seed(0))
    ours_bn = copy.deepcopy(model.spynet.block0.bn0)
    for bn in (plain, ours_bn):
        bn.running_mean.copy_(start["mean"])
        bn.running_var.copy_(start["var"])
        bn(probe)
    assert (plain.running_var - ours_bn.running_var).abs().max() > 1e-3


def test_bf16_forward_no_worse_than_jax_bf16(variables):
    """bf16 convs, fp32 frames / flows / warps / output. The port's bf16
    error against the fp32 JAX output is at most 1.5x JAX's own bf16 error,
    in the mean and in the max."""
    x = _frames((2, T, H, W, 3), 7)
    ref32 = np.asarray(jax.jit(JaxTOFlow(s2d=False).apply)(variables, jnp.asarray(x)))
    ref16 = np.asarray(jax.jit(JaxTOFlow(s2d=False, dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = _torch_tof(variables, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    ours_err, jax_err = np.abs(ours.numpy() - ref32), np.abs(ref16 - ref32)
    assert 0 < ours_err.mean() <= 1.5 * jax_err.mean()
    assert ours_err.max() <= 1.5 * jax_err.max()


def test_input_conventions_match_jax(variables):
    """arch_mod / tof_raw_mod as JAX's; TOFlow(pre_upscale=True) on raw LR
    through make_model_apply equals the apply's own pre-upscale of the same
    LR (raw 4x4 needs no padding either way); exact up to 1e-6."""
    for which in ("EDVR", "TOF", "DUF_16L", None):
        assert padding.arch_mod(which) == jax_padding.arch_mod(which)
    for scale in (1, 2, 3, 4, 8):
        assert padding.tof_raw_mod(scale) == jax_padding.tof_raw_mod(scale)
    lr = torch.from_numpy(_frames((2, T, 4, 4, 3), 14))
    folded = _torch_tof(variables, pre_upscale=True)
    apply = make_model_apply("TOF", 4)
    with torch.no_grad():
        a = apply(folded, lr)
        b = apply(_torch_tof(variables), lr)
    assert a.shape == b.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ------------------------------------------------------------ adaptation
K, STEPS, LR = 2, 2, 1e-5
SLR_HW, LR_HW = (4, 4), (16, 16)


@pytest.fixture(scope="module")
def adapt_data(variables):
    """SLR windows (K, T, 4, 4, 3) -> pre-upscaled to 16x16 inside the
    apply; their LR centres; 3 inference windows of 16x16 LR (64x64 after
    the pre-upscale)."""
    return dict(slr=_frames((K, T) + SLR_HW + (3,), 8),
                centers=_frames((K,) + LR_HW + (3,), 9) * 0.5 + 0.25,
                windows=_frames((3, T) + LR_HW + (3,), 10))


def test_train_ema_adaptation_matches_jax(variables, adapt_data):
    """2 Adam steps (lr 1e-5) in bn_mode train_ema with the bicubic
    pre-upscale + mod-8 apply, then eval-mode inference on the EMA'd
    statistics. Losses 1e-5 relative; final running stats 5e-5 absolute;
    SR 2e-4 absolute, three orders under what adaptation moved it by
    (checked). Why not tighter: Adam moves every parameter by ~lr whatever
    its gradient's size, and the conv biases in front of a train-mode
    BatchNorm get gradients at fp32 noise level, so the two frameworks may
    step such a bias by lr in opposite directions; it reaches the running
    means and, in eval mode, the SR."""
    d = adapt_data
    net = JaxTOFlow(s2d=False)
    jcfg = JaxAdaptConfig(n_steps=STEPS, lr=LR, bn_mode="train_ema")
    adapt_j = jax.jit(jax_make_adapt_fn(
        net, jcfg, jit=False, apply_fn=jax_model_apply(net, "TOF", 4),
        mutable_apply_fn=jax_mutable_apply(net, "TOF", 4)))
    adapted_j, losses_j = adapt_j(variables, jnp.asarray(d["slr"]), jnp.asarray(d["centers"]))
    sr_j = np.asarray(jax.jit(lambda p, w: jax_chunked_apply(
        jax_model_apply(net, "TOF", 4), p, w, 2))(adapted_j, jnp.asarray(d["windows"])))

    meta = _torch_tof(variables)
    cfg = AdaptConfig(n_steps=STEPS, lr=LR, bn_mode="auto", infer_chunk=2)
    adapt = make_adapt_fn(cfg, make_model_apply("TOF", 4), make_mutable_model_apply("TOF", 4))
    adapted, losses = adapt(meta, *(torch.from_numpy(d[k]) for k in ("slr", "centers")))
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    sd = adapted.state_dict()
    for k, v in _stats(_np(adapted_j)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=5e-5, err_msg=k)

    run = make_adapt_and_infer(cfg, make_model_apply("TOF", 4), make_mutable_model_apply("TOF", 4))
    sr, losses2 = run(meta, *(torch.from_numpy(d[k]) for k in ("slr", "centers", "windows")))
    assert sr.shape == sr_j.shape == (3, 64, 64, 3)
    np.testing.assert_array_equal(losses2.numpy(), losses.numpy())
    np.testing.assert_allclose(sr.numpy(), sr_j, atol=2e-4)
    with torch.no_grad():
        unadapted = make_model_apply("TOF", 4)(meta, torch.from_numpy(d["windows"])).numpy()
    assert np.abs(unadapted - sr.numpy()).max() > 0.1


def test_adapting_leaves_the_meta_model_and_its_statistics_alone(variables, adapt_data):
    """The per-clip deep copy keeps one clip's EMA'd statistics (and its
    Adam steps) out of the meta model and so out of the next clip."""
    d = adapt_data
    meta = _torch_tof(variables)
    before = {k: v.clone() for k, v in meta.state_dict().items()}
    adapt = make_adapt_fn(AdaptConfig(n_steps=STEPS, lr=LR), make_model_apply("TOF", 4),
                          make_mutable_model_apply("TOF", 4))
    args = [torch.from_numpy(d[k]) for k in ("slr", "centers")]
    adapted_a, losses_a = adapt(meta, *args)
    for k, v in meta.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not torch.equal(adapted_a.spynet.block1.bn2.running_var,
                           before["spynet.block1.bn2.running_var"])
    _, losses_b = adapt(meta, *args)
    torch.testing.assert_close(losses_b, losses_a, rtol=0, atol=0)


def test_resolve_bn_mode_and_grad_stats_refusal(variables, adapt_data):
    tof, edvr = _torch_tof(variables), EDVR(nf=8, nframes=3, groups=2, front_RBs=1,
                                            back_RBs=1)
    assert resolve_bn_mode("auto", tof) == "train_ema"
    assert resolve_bn_mode("auto", edvr) == "grad_stats"
    assert resolve_bn_mode("grad_stats", tof) == "grad_stats"
    assert resolve_bn_mode("train_ema", edvr) == "train_ema"
    args = [torch.from_numpy(adapt_data[k]) for k in ("slr", "centers")]
    # grad_stats on a BatchNorm net is ported (test_torch_port_surface.py
    # holds it against JAX); only an unknown mode is refused.
    _, losses = make_adapt_fn(AdaptConfig(n_steps=1, bn_mode="grad_stats"),
                              make_model_apply("TOF", 4))(tof, *args)
    assert losses.shape == (1,) and bool(torch.isfinite(losses).all())
    with pytest.raises(ValueError, match="bn_mode"):
        make_adapt_fn(AdaptConfig(n_steps=1, bn_mode="ema"))(tof, *args)


def test_define_g_builds_tof_and_refuses_what_is_not_ported():
    opt = {"scale": 4, "network_G": {"which_model_G": "TOF", "nframes": 7}}
    net = define_G(opt, device="cpu")
    assert isinstance(net, TOFlow) and not net.pre_upscale
    assert net.conv_3x7_64_9x9.weight.shape == (64, 21, 9, 9)
    net16 = define_G({**opt, "network_G": {**opt["network_G"], "dtype": "bf16",
                                           "pre_upscale": True}}, device="cpu")
    assert net16.pre_upscale and net16.conv_64_64_9x9.compute_dtype == torch.bfloat16
    assert isinstance(define_G({"network_G": {"which_model_G": "MFDN", "nf": 8, "nframes": 3}},
                               device="cpu"), MFDN)
    for which, layers in (("DUF_16L", 3), ("DUF_28L", 9), ("DUF_52L", 21)):
        assert define_G({"network_G": {"which_model_G": which}},
                        device="cpu").dense1_layers == layers
    # SFDN is ported now; a name define_G does not know is refused.
    assert isinstance(define_G({"network_G": {"which_model_G": "SFDN", "nf": 8}},
                               device="cpu"), SFDN)
    with pytest.raises(NotImplementedError, match="not recognized"):
        define_G({"network_G": {"which_model_G": "FRVSR"}}, device="cpu")
    # network_G.s2d_conv (JAX's space-to-depth conv schedule, same output as
    # the plain convs) builds the same network in the port: exactly the same
    # CPU output on the same weights.
    edvr = {"nf": 8, "nframes": 3, "groups": 2, "front_RBs": 1, "back_RBs": 1}
    for which, extra, shape in (("TOF", {"nframes": T}, (1, T, H, W, 3)),
                                ("DUF_16L", {"nframes": 7}, (1, 7, 8, 10, 3)),
                                ("EDVR", edvr, (1, 3, H, W, 3))):
        base = {"which_model_G": which, **extra}
        plain = define_G({"scale": 4, "network_G": base}, device="cpu").eval()
        s2d = define_G({"scale": 4, "network_G": {**base, "s2d_conv": True}}, device="cpu")
        s2d.load_state_dict(plain.state_dict(), strict=True)
        x = torch.from_numpy(_frames(shape, 9))
        with torch.no_grad():
            torch.testing.assert_close(s2d.eval()(x), plain(x), rtol=0, atol=0)


def test_reference_pth_loads_strictly_and_matches_the_torch_replica(tmp_path):
    """A reference-layout TOFlow state_dict (tests/torch_replicas.py, with
    nn.BatchNorm2d buffers) loads strictly through the entry points'
    load_pretrained, and the eval forwards agree (the replica warps with F.grid_sample); 1e-4."""
    torch.manual_seed(0)
    ref = tr.TOFlow().eval()
    with torch.no_grad():
        for name, buf in ref.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
    path = tmp_path / "TOF_official.pth"
    torch.save({"module." + k: v for k, v in ref.state_dict().items()}, path)
    ours = define_G({"network_G": {"which_model_G": "TOF"}}, device="cpu")
    load_pretrained(ours, str(path))
    x = _frames((1, 7, 16, 16, 3), 11)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).permute(0, 2, 3, 1).numpy()
        got = ours.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_run_clip_tof_falls_back_from_seq_and_matches_windows(variables, caplog):
    """run_clip on a TOFlow (its `arch` picks TOF's input convention) through
    MFDN: seq=True warns and runs the window-batched path, so both give the
    same frames; the meta model's statistics are untouched."""
    lq = _frames((4,) + LR_HW + (3,), 12)
    tof = _torch_tof(variables)
    est = MFDN(scale=4, nf=8, nframes=T).eval()
    before = {k: v.clone() for k, v in tof.state_dict().items()}
    cfg = AdaptConfig(n_steps=1, lr=LR, infer_chunk=2)
    kw = dict(n_frames=T, padding="reflection", n_adapt=2, device="cpu")
    sr_w, res_w = run_clip(tof, est, lq, None, cfg, seq=False, **kw)
    with caplog.at_level("WARNING", logger="dynavsr_tpu_torch"):
        sr_s, res_s = run_clip(tof, est, lq, None, cfg, seq=True, **kw)
    assert "window-batched" in caplog.text
    assert sr_w.shape == (4, 64, 64, 3) and np.isfinite(sr_w).all()
    np.testing.assert_array_equal(sr_s, sr_w)
    assert res_s["adapt_losses"] == res_w["adapt_losses"]
    for k, v in tof.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_cli_runs_tof_on_cpu_from_yaml(tmp_path, caplog):
    """main() with network_G.which_model_G TOF (3 frames) from a tmp YAML on
    an image-folder clip, device='cpu'; adapt.seq falls back with a warning."""
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.cli.test_dynavsr import main

    rng = np.random.default_rng(13)
    for i in range(5):
        for root, (h, w) in (("LQ", LR_HW), ("GT", (64, 64))):
            d = tmp_path / root / "walk"
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"{i:08d}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    opt = tmp_path / "tof.yml"
    opt.write_text(f"""
name: tiny_tof
scale: 4
datasets:
  test:
    mode: video_test
    dataroot_GT: {tmp_path / 'GT'}
    dataroot_LQ: {tmp_path / 'LQ'}
    padding: new_info
network_G: {{which_model_G: TOF, nframes: 3}}
network_E: {{which_model_G: MFDN, nf: 8}}
adapt: {{n_steps: 2, lr: 1.0e-5, n_windows: 2, infer_chunk: 2, seq: true, bn_mode: auto}}
path: {{root: {tmp_path}}}
eval: {{ycbcr: true}}
""")
    with caplog.at_level("WARNING", logger="dynavsr_tpu_torch"):
        res = main(["-opt", str(opt), "--device", "cpu", "--no-save-images"])
    assert "window-batched" in caplog.text
    assert np.isfinite(res["walk"]["psnr_avg"]) and len(res["walk"]["adapt_losses"]) == 2
    assert res["_avg"]["psnr_avg"] == res["walk"]["psnr_avg"]
