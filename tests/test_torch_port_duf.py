"""The port's DUF (3-D dense trunk, dynamic upsampling filter; train-mode
BatchNorm with flax's momentum 0.99), its DynaVSR-DUF adaptation and
`duf_downsample` against the JAX package's, on CPU.

Weights are the JAX init's with the BatchNorm scales, biases and running
statistics redrawn, carried over by
convert/from_jax.py:jax_params_to_state_dict; inputs are numpy draws from a
seed. DUF-16L at full width (64-channel stem, growth 32, 256/512-channel
heads) with one dense-1 layer in place of three, on 7 frames of 8x10 LR.
CPU tensors take the plain filter (ops/duf_filter_ref.py); the kernels are
held against it on the card (test_torch_port_kernels.py). Tolerances are
stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_replicas as tr  # tests/ is on sys.path under pytest rootdir
from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
from dynavsr_tpu.adapt.adaptation import chunked_apply as jax_chunked_apply
from dynavsr_tpu.adapt.adaptation import make_adapt_fn as jax_make_adapt_fn
from dynavsr_tpu.data.degradations import duf_downsample as jax_duf_downsample
from dynavsr_tpu.models.duf import DUF as JaxDUF
from dynavsr_tpu.models.duf import dynamic_upsampling_filter as jax_duf_filter
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.models.padding import make_mutable_model_apply as jax_mutable_apply
from dynavsr_tpu_torch.adapt.adaptation import (
    AdaptConfig,
    make_adapt_and_infer,
    make_adapt_fn,
    resolve_bn_mode,
)
from dynavsr_tpu_torch.cli.test_dynavsr import _load_pth
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.data.degradations import duf_downsample
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
from dynavsr_tpu_torch.ops import duf_filter
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref

T, H, W, LAYERS = 7, 8, 10, 1


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_duf(variables, dtype=None):
    model = DUF(dense1_layers=LAYERS, dtype=dtype)
    model.load_state_dict(jax_params_to_state_dict(variables, model.state_dict()), strict=True)
    return model.eval()


def _stats(variables):
    sd = jax_params_to_state_dict(variables)
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def variables():
    """JAX DUF init; every BatchNorm's scale, bias and running statistics
    moved off 1 / 0 / 0 / 1, so eval mode reads them."""
    x = jnp.asarray(_frames((1, T, H, W, 3), 0))
    v = _np(jax.jit(JaxDUF(dense1_layers=LAYERS).init)(jax.random.PRNGKey(0), x))
    rng = np.random.default_rng(1)

    def redraw(tree, draws):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                if k.startswith("bn"):
                    for name, fn in draws.items():
                        leaf[name] = fn(leaf[name].shape).astype(np.float32)
                else:
                    redraw(leaf, draws)

    redraw(v["params"], {"scale": lambda s: rng.uniform(0.5, 1.5, s),
                         "bias": lambda s: rng.standard_normal(s) * 0.1})
    redraw(v["batch_stats"], {"mean": lambda s: rng.standard_normal(s) * 0.1,
                              "var": lambda s: rng.uniform(0.5, 2.0, s)})
    return v


# ------------------------------------------------------------ the filter (X4)
def _filter_inputs(r, seed):
    """Centre frame (2, 7, 9, 3) and raw N(0, 1) filters (2, 7, 9, 25, R):
    unnormalised, so their sums cancel and an error of the sum shows."""
    rng = np.random.default_rng(seed)
    return (rng.random((2, 7, 9, 3)).astype(np.float32),
            rng.standard_normal((2, 7, 9, 25, r)).astype(np.float32),
            rng.standard_normal((2, 7, 9, 3 * r)).astype(np.float32))


@pytest.mark.parametrize("fdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [4, 16])
def test_plain_filter_and_its_vjp_match_jax(r, fdtype):
    """The plain filter on NCHW planes against the JAX function on NHWC:
    forward 1e-6 and grad x 1e-5 of the largest reference value (fp32
    sums, another order). Grad filters: fp32 1e-5 likewise; bf16 filters
    get their gradient rounded to bf16 by both frameworks, and the same
    fp32 sum rounded on either side of a bf16 boundary differs by one bf16
    step (at most 2^-7 of the value, 8 significant bits), so there 2^-7 of
    the value plus 1e-5 of the largest; it happens to a few elements of
    tens of thousands."""
    x, f, g = _filter_inputs(r, seed=r)
    jf = jnp.asarray(f, dtype=jnp.dtype(fdtype))
    want, vjp = jax.vjp(jax_duf_filter, jnp.asarray(x), jf)
    want_gx, want_gf = (np.asarray(a, np.float32) for a in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    ft = torch.from_numpy(f).to(getattr(torch, fdtype)).permute(0, 3, 4, 1, 2).contiguous()
    ft.requires_grad_()
    out = dynamic_upsampling_filter_ref(xt, ft)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 3 * r, 7, 9)
    out.backward(torch.from_numpy(g).permute(0, 3, 1, 2))
    assert ft.grad.dtype == ft.dtype
    want = np.asarray(want)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), want_gx,
                               rtol=0, atol=1e-5 * np.abs(want_gx).max())
    got_gf = ft.grad.float().permute(0, 3, 4, 1, 2).numpy()
    np.testing.assert_allclose(got_gf, want_gf, rtol=0 if fdtype == "float32" else 2 ** -7,
                               atol=1e-5 * np.abs(want_gf).max())


def test_cpu_tensors_take_the_plain_filter_and_count_nothing():
    x, f, _ = _filter_inputs(16, seed=3)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    ft = torch.from_numpy(f).permute(0, 3, 4, 1, 2).contiguous()
    duf_filter.reset_launch_counts()
    out = duf_filter.dynamic_upsampling_filter(xt, ft)
    np.testing.assert_array_equal(out.numpy(), dynamic_upsampling_filter_ref(xt, ft).numpy())
    assert duf_filter.launch_counts() == {"duf_fwd": 0, "duf_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        duf_filter.duf_fwd(xt, ft)
    with pytest.raises(ValueError, match="CUDA"):
        duf_filter.duf_bwd(xt, ft, torch.zeros(2, 48, 7, 9), need_x=True)


# ------------------------------------------------------------ the network
def test_duf_eval_forward_matches_jax(variables):
    """Eval mode on the redrawn running statistics; 1e-4 absolute on
    outputs of O(1)."""
    x = _frames((2, T, H, W, 3), 5)
    want = np.asarray(jax.jit(JaxDUF(dense1_layers=LAYERS).apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _torch_duf(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(want).max() > 0.1


def test_duf_s2d_eval_forward_matches_jax(variables):
    """JAX's DUF with s2d=True (`network_G.s2d_conv`: the dense trunk in the
    spatially packed channel-major domain, taken since 8x10 is even) against
    the port's DUF, which runs plain convs for that key: the same weights,
    eval mode; 1e-4 absolute on outputs of O(1), as the plain schedule."""
    x = _frames((2, T, H, W, 3), 8)
    want = np.asarray(jax.jit(JaxDUF(dense1_layers=LAYERS, s2d=True).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _torch_duf(variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * H, 4 * W, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(want).max() > 0.1


def test_duf_train_forward_and_batch_stats_match_jax(variables):
    """Train mode: batch statistics in the forward and one EMA step of
    every BatchNorm with flax's default momentum 0.99. Output and running
    statistics 1e-5 absolute. TOF's momentum (flax 0.9, torch 0.1) would
    miss by far more: checked."""
    x = _frames((2, T, H, W, 3), 6)
    train = JaxDUF(dense1_layers=LAYERS, train=True)
    want, upd = jax.jit(lambda v, a: train.apply(v, a, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model = _torch_duf(variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    want_stats = _stats({"params": variables["params"], "batch_stats": _np(upd["batch_stats"])})
    sd = model.state_dict()
    for k, v in want_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert int(sd["bn3d_2.num_batches_tracked"]) == 1
    # The same step at TOF's momentum misses.
    before = _stats(variables)
    tof_like = {k: before[k] + 0.1 * (want_stats[k] - before[k]) / 0.01 for k in before}
    miss = max(float((tof_like[k] - want_stats[k]).abs().max()) for k in before)
    assert miss > 1e-2


def test_bf16_duf_no_worse_than_jax_bf16(variables):
    """bf16 convs and softmax, fp32 BatchNorm, centre frame, filter
    application and output. The port's bf16 error against the fp32 JAX
    output is at most 1.5x JAX's own bf16 error, in the mean and in the
    max."""
    x = _frames((2, T, H, W, 3), 7)
    ref32 = np.asarray(jax.jit(JaxDUF(dense1_layers=LAYERS).apply)(variables, jnp.asarray(x)))
    ref16 = np.asarray(jax.jit(JaxDUF(dense1_layers=LAYERS, dtype=jnp.bfloat16).apply)(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = _torch_duf(variables, dtype=torch.bfloat16)(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    ours_err, jax_err = np.abs(ours.numpy() - ref32), np.abs(ref16 - ref32)
    assert 0 < ours_err.mean() <= 1.5 * jax_err.mean()
    assert ours_err.max() <= 1.5 * jax_err.max()


def test_define_g_builds_the_duf_variants():
    for which, layers in (("DUF_16L", 3), ("DUF_28L", 9), ("DUF_52L", 21)):
        net = define_G({"network_G": {"which_model_G": which, "nframes": 7}}, device="cpu")
        assert isinstance(net, DUF) and net.dense1_layers == layers
        assert net.conv3d_2.weight.shape == (256, 64 + 32 * (layers + 3), 1, 3, 3)
        assert resolve_bn_mode("auto", net) == "train_ema"
    net16 = define_G({"network_G": {"which_model_G": "DUF_16L", "dtype": "bf16"}}, device="cpu")
    assert net16.dense2_2.conv2.compute_dtype == torch.bfloat16
    assert net16.bn3d_2.momentum == 0.01
    with pytest.raises(ValueError, match="7 frames"):
        net(torch.zeros(1, 5, 4, 4, 3))


# ------------------------------------------------------------ adaptation
K, STEPS, LR = 2, 2, 1e-5
SLR_HW, LR_HW = (2, 3), (8, 12)


def test_train_ema_adaptation_matches_jax(variables):
    """2 Adam steps (lr 1e-5) in bn_mode train_ema on SLR windows of 2x3
    against their 8x12 LR centres, then eval-mode inference on the EMA'd
    statistics over 3 windows in chunks of 2. Losses 1e-5 relative; final
    running stats 1e-5 absolute; SR 1e-4 absolute, orders under what
    adaptation moved it by (checked). As for TOF, Adam moves every
    parameter by ~lr whatever its gradient's size, and the conv biases in
    front of a train-mode BatchNorm get gradients at fp32 noise level."""
    slr = _frames((K, T) + SLR_HW + (3,), 8)
    centers = _frames((K,) + LR_HW + (3,), 9) * 0.5 + 0.25
    windows = _frames((3, T) + LR_HW + (3,), 10)
    net = JaxDUF(dense1_layers=LAYERS)
    jcfg = JaxAdaptConfig(n_steps=STEPS, lr=LR, bn_mode="train_ema")
    adapt_j = jax.jit(jax_make_adapt_fn(
        net, jcfg, jit=False, apply_fn=jax_model_apply(net, "DUF_16L", 4),
        mutable_apply_fn=jax_mutable_apply(net, "DUF_16L", 4)))
    adapted_j, losses_j = adapt_j(variables, jnp.asarray(slr), jnp.asarray(centers))
    sr_j = np.asarray(jax.jit(lambda p, w: jax_chunked_apply(
        jax_model_apply(net, "DUF_16L", 4), p, w, 2))(adapted_j, jnp.asarray(windows)))

    meta = _torch_duf(variables)
    cfg = AdaptConfig(n_steps=STEPS, lr=LR, bn_mode="auto", infer_chunk=2)
    apply, mutable = make_model_apply("DUF", 4), make_mutable_model_apply("DUF", 4)
    adapted, losses = make_adapt_fn(cfg, apply, mutable)(
        meta, torch.from_numpy(slr), torch.from_numpy(centers))
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    sd = adapted.state_dict()
    for k, v in _stats(_np(adapted_j)).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)

    run = make_adapt_and_infer(cfg, apply, mutable)
    sr, losses2 = run(meta, *(torch.from_numpy(a) for a in (slr, centers, windows)))
    assert sr.shape == sr_j.shape == (3, 4 * LR_HW[0], 4 * LR_HW[1], 3)
    np.testing.assert_array_equal(losses2.numpy(), losses.numpy())
    np.testing.assert_allclose(sr.numpy(), sr_j, atol=1e-4)
    with torch.no_grad():
        unadapted = apply(meta, torch.from_numpy(windows)).numpy()
    assert np.abs(unadapted - sr.numpy()).max() > 1e-2


# ------------------------------------------------------------ checkpoints, data, CLI
def test_reference_pth_loads_strictly_and_matches_the_torch_replica(tmp_path):
    """A reference-layout DUF-16L state_dict (tests/torch_replicas.py, with
    nn.BatchNorm3d buffers) loads strictly through the CLI's _load_pth, and
    the eval forwards agree (the replica filters with an einsum); 1e-4."""
    torch.manual_seed(0)
    ref = tr.DUF(scale=4, dense1_layers=3).eval()
    with torch.no_grad():
        for name, buf in ref.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
    path = tmp_path / "DUF_16L.pth"
    torch.save({"module." + k: v for k, v in ref.state_dict().items()}, path)
    ours = define_G({"network_G": {"which_model_G": "DUF_16L"}}, device="cpu")
    _load_pth(ours, str(path))
    x = _frames((1, T, 6, 7, 3), 11)
    with torch.no_grad():
        want = ref(torch.from_numpy(x).permute(0, 1, 4, 2, 3)).permute(0, 2, 3, 1).numpy()
        got = ours.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_duf_downsample_matches_jax(scale):
    """The blur-matched LR of a (2, 3, 40, 44) HR stack; 1e-6 (the same
    13x13 fp32 conv)."""
    hr = _frames((2, 3, 40, 44, 3), 12 + scale)
    want = np.asarray(jax_duf_downsample(jnp.asarray(hr), scale))
    got = duf_downsample(torch.from_numpy(hr), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_cli_runs_duf_on_cpu_from_yaml(tmp_path, caplog):
    """main() with network_G.which_model_G DUF_16L (7 frames) from a tmp YAML
    on an image-folder clip, device='cpu'; adapt.seq falls back to the
    window-batched path with a warning; crop_border 8 as DUF's config."""
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.cli.test_dynavsr import main

    rng = np.random.default_rng(13)
    for i in range(8):
        for root, (h, w) in (("LQ", LR_HW), ("GT", (32, 48))):
            d = tmp_path / root / "walk"
            d.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(d / f"{i:08d}.png"), rng.integers(0, 256, (h, w, 3), np.uint8))
    opt = tmp_path / "duf.yml"
    opt.write_text(f"""
name: tiny_duf
scale: 4
datasets:
  test:
    dataroot_GT: {tmp_path / 'GT'}
    dataroot_LQ: {tmp_path / 'LQ'}
    padding: new_info
network_G: {{which_model_G: DUF_16L, nframes: 7}}
network_E: {{which_model_G: MFDN, nf: 8}}
adapt: {{n_steps: 2, lr: 1.0e-5, n_windows: 2, infer_chunk: 2, seq: true}}
path: {{root: {tmp_path}}}
eval: {{ycbcr: true, crop_border: 8}}
""")
    with caplog.at_level("WARNING", logger="dynavsr_tpu_torch"):
        res = main(["-opt", str(opt), "--device", "cpu", "--no-save-images"])
    assert "window-batched" in caplog.text
    assert np.isfinite(res["walk"]["psnr_avg"]) and len(res["walk"]["adapt_losses"]) == 2
    assert res["_avg"]["psnr_avg"] == res["walk"]["psnr_avg"]
