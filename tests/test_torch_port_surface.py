"""The rest of the port's serving surface against the JAX package, on CPU:
the downscalers (SFDN, bf16 MFDN / SFDN), BatchNorm in eval mode with
gradients in its running statistics, adaptation in bn_mode 'grad_stats' on
BatchNorm nets and with the 'sgd' optimizer, the test sets and their
factory, the evaluation harness, the port's checkpoints and the shared
loader, and every configs/test/*.yml network built through define_G.

Weights are the JAX init's (redrawn where stated), carried over by
convert/from_jax.py:jax_params_to_state_dict; inputs are numpy draws from a
seed, image trees are written with cv2. Tolerances are stated per test.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
from dynavsr_tpu.adapt.adaptation import make_adapt_fn as jax_make_adapt_fn
from dynavsr_tpu.data import datasets as jax_datasets
from dynavsr_tpu.eval.harness import evaluate_dataset as jax_evaluate_dataset
from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
from dynavsr_tpu.models.downscaler import SFDN as JaxSFDN
from dynavsr_tpu.models.duf import DUF as JaxDUF
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_fn
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator
from dynavsr_tpu_torch.config.options import parse
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.data import datasets
from dynavsr_tpu_torch.data.loader import create_dataset
from dynavsr_tpu_torch.eval.harness import evaluate_dataset
from dynavsr_tpu_torch.models.arch_util import BatchNorm2d, BatchNorm3d
from dynavsr_tpu_torch.models.downscaler import MFDN, SFDN
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.tof import TOFlow
from dynavsr_tpu_torch.models.video_base_model import VideoBaseModel, create_model
from dynavsr_tpu_torch.train.checkpoint import (
    latest_checkpoint_iter,
    load_network,
    load_pretrained,
    save_network,
)

ROOT = Path(__file__).resolve().parents[1]


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(model, variables):
    model.load_state_dict(jax_params_to_state_dict(variables, model.state_dict()), strict=True)
    return model.eval()


# ------------------------------------------------------------ downscalers
@pytest.mark.parametrize("which,bf16", [("SFDN", False), ("SFDN", True), ("MFDN", True)],
                         ids=["SFDN-fp32", "SFDN-bf16", "MFDN-bf16"])
def test_downscaler_matches_jax(which, bf16):
    """nf 8 on (2, 3, 16, 20, 3) -> (2, 3, 4, 5, 3) fp32, against the JAX
    module with the same dtype. fp32 1e-6 (the same convs, another
    summation order); bf16 1e-3, a bf16 step (2^-8) of the O(0.1)
    correction over the bicubic base, with margin. SFDN also takes single
    frames, and runs each frame alone."""
    x = _frames((2, 3, 16, 20, 3), 0)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jnet = (JaxSFDN if which == "SFDN" else JaxMFDN)(scale=4, nf=8, dtype=jdt)
    variables = _np(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(jnet.apply(variables, jnp.asarray(x)))
    opt = {"scale": 4, "network_G": {"which_model_G": which, "nf": 8, "nframes": 3,
                                     "dtype": "bfloat16" if bf16 else None}}
    net = _load(define_G(opt, device="cpu"), variables)
    assert isinstance(net, SFDN if which == "SFDN" else MFDN)
    assert net.body0.compute_dtype == tdt
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 3, 4, 5, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-3 if bf16 else 1e-6)
    if bf16:  # the convs did run in bf16
        fp32 = _load(define_G({**opt, "network_G": {**opt["network_G"], "dtype": None}},
                              device="cpu"), variables)
        with torch.no_grad():
            assert float((fp32(torch.from_numpy(x)) - out).abs().max()) > 0
    if which == "SFDN":
        with torch.no_grad():
            single = net(torch.from_numpy(x[:, 1]))
        np.testing.assert_allclose(single.numpy(), out[:, 1].numpy(), rtol=0, atol=0)
        np.testing.assert_allclose(
            single.numpy(), np.asarray(jnet.apply(variables, jnp.asarray(x[:, 1]))),
            atol=1e-3 if bf16 else 1e-6)


# ------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("cls,shape", [(BatchNorm2d, (2, 6, 5, 7)),
                                       (BatchNorm3d, (2, 6, 3, 5, 7))], ids=["2d", "3d"])
def test_eval_batch_norm_with_grad_in_its_statistics_matches_the_fused_op(cls, shape):
    """Eval mode with running statistics that require grad (bn_mode
    'grad_stats') takes the written-out formula: the same output as the
    fused F.batch_norm within 1e-6 relative (fp32, another order), and
    gradients in the statistics equal to the formula's derivative
    (1e-5 relative)."""
    rng = np.random.default_rng(3)
    bn = cls(6).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 6).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    fused = bn(x)
    for buf in (bn.running_mean, bn.running_var):
        buf.requires_grad_(True)
    y = bn(x)
    torch.testing.assert_close(y, fused, rtol=1e-6, atol=1e-6)
    g_mean, g_var = torch.autograd.grad(y, (bn.running_mean, bn.running_var), cot)
    dims = (0, *range(2, x.dim()))
    view = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(bn.running_var.detach() + bn.eps)
    want_mean = -(cot * (bn.weight.detach() * inv).view(view)).sum(dims)
    want_var = (cot * (x - bn.running_mean.detach().view(view))
                * (bn.weight.detach() * -0.5 * inv ** 3).view(view)).sum(dims)
    torch.testing.assert_close(g_mean, want_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(g_var, want_var, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ adaptation
def _redraw_stats(variables, seed):
    """Running statistics moved off 0 / 1, so eval mode reads them."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        for leaf in tree.values():
            if isinstance(leaf, dict) and "mean" in leaf:
                leaf["mean"] = (rng.standard_normal(leaf["mean"].shape) * 0.1).astype(np.float32)
                leaf["var"] = rng.uniform(0.5, 2.0, leaf["var"].shape).astype(np.float32)
            elif isinstance(leaf, dict):
                walk(leaf)

    walk(variables["batch_stats"])
    return variables


STEPS = 2


def _compare_adapted(adapted, jax_adapted, start, atol):
    """Every adapted tensor (weights and running statistics) against JAX's
    within `atol`; returns the smallest move of a running statistic."""
    want = jax_params_to_state_dict(_np(jax_adapted))
    got = adapted.state_dict()
    assert set(got) == set(want)
    moved = []
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, err_msg=k)
        if "running" in k:
            moved.append(float((v - start[k]).abs().max()))
    return min(moved) if moved else None


@pytest.mark.parametrize("which", ["TOF", "DUF"])
def test_grad_stats_adaptation_on_batch_norm_nets_matches_jax(which):
    """bn_mode 'grad_stats': 2 Adam steps (lr 1e-4) in eval mode, the
    running statistics stepped with the weights, as JAX's make_adapt_fn
    does with the whole variables dict. TOF (3 frames, SLR 4x4 pre-upscaled
    to 16x16) and DUF-16L with one dense-1 layer (7 frames, SLR 2x3).
    Losses 1e-5 relative; every adapted tensor 5e-6 absolute, 1/40 of
    Adam's 2-step move (2e-4, which every running statistic makes:
    checked). The meta model, its statistics included, does not move, and
    the statistics are buffers again afterwards."""
    if which == "TOF":
        t, jnet, net, jwhich = 3, JaxTOFlow(s2d=False), TOFlow(nframes=3), "TOF"
        slr, centers, x0 = (_frames((2, t, 4, 4, 3), 8), _frames((2, 16, 16, 3), 9),
                            _frames((1, t, 16, 16, 3), 0))
    else:
        t, jnet, net, jwhich = 7, JaxDUF(dense1_layers=1), DUF(dense1_layers=1), "DUF_16L"
        slr, centers, x0 = (_frames((2, t, 2, 3, 3), 8), _frames((2, 8, 12, 3), 9),
                            _frames((1, t, 8, 12, 3), 0))
    variables = _redraw_stats(_np(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x0))),
                              1)
    jcfg = JaxAdaptConfig(n_steps=STEPS, lr=1e-4, bn_mode="grad_stats")
    adapted_j, losses_j = jax_make_adapt_fn(
        jnet, jcfg, jit=True, apply_fn=jax_model_apply(jnet, jwhich, 4))(
        variables, jnp.asarray(slr), jnp.asarray(centers))

    meta = _load(net, variables)
    before = {k: v.clone() for k, v in meta.state_dict().items()}
    cfg = AdaptConfig(n_steps=STEPS, lr=1e-4, bn_mode="grad_stats")
    adapted, losses = make_adapt_fn(cfg, make_model_apply(meta.arch, 4))(
        meta, torch.from_numpy(slr), torch.from_numpy(centers))
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    moved = _compare_adapted(adapted, adapted_j, before, atol=5e-6)
    assert moved > 1.9e-4
    for k, v in meta.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert not any(b.requires_grad for m in (meta, adapted) for b in m.buffers())


def test_sgd_adaptation_on_edvr_matches_jax():
    """optimizer 'sgd' (optax.sgd: no momentum, no weight decay): 2 steps at
    lr 1e-2 on a tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 RBs; offset convs
    redrawn off zero) through the mod-padded apply. Losses 1e-5 relative;
    adapted weights 1e-6 absolute, against moves up to ~1e-2 (checked)."""
    cfg_net = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
    rng = np.random.default_rng(0)
    jnet = JaxEDVR(**cfg_net)
    variables = _np(jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 20, 3))))
    for dcn in ("L1_dcnpack", "L2_dcnpack", "L3_dcnpack", "cas_dcnpack"):
        om = variables["params"]["pcd_align"][dcn]["conv_offset_mask"]
        om["kernel"] = (rng.standard_normal(om["kernel"].shape) * 0.05).astype(np.float32)
    slr, centers = _frames((2, 3, 4, 5, 3), 4), _frames((2, 16, 20, 3), 5)
    jcfg = JaxAdaptConfig(n_steps=STEPS, lr=1e-2, optimizer="sgd")
    adapted_j, losses_j = jax_make_adapt_fn(
        jnet, jcfg, jit=True, apply_fn=jax_model_apply(jnet, "EDVR", 4))(
        variables, jnp.asarray(slr), jnp.asarray(centers))
    meta = _load(EDVR(**cfg_net), variables)
    before = copy.deepcopy(meta.state_dict())
    adapted, losses = make_adapt_fn(AdaptConfig(n_steps=STEPS, lr=1e-2, optimizer="sgd"),
                                    make_model_apply("EDVR", 4))(
        meta, torch.from_numpy(slr), torch.from_numpy(centers))
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-5)
    _compare_adapted(adapted, adapted_j, before, atol=1e-6)
    assert max(float((adapted.state_dict()[k] - v).abs().max()) for k, v in before.items()) > 1e-3
    for k, v in meta.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="optimizer"):
        make_adapt_fn(AdaptConfig(n_steps=1, optimizer="rmsprop"))(
            meta, torch.from_numpy(slr), torch.from_numpy(centers))


# ------------------------------------------------------------ data and harness
def _write_tree(root, layout, h, w, seed):
    """layout: {relative clip dir: frame file names}; random uint8 frames."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    for clip, names in layout.items():
        d = Path(root) / clip
        d.mkdir(parents=True, exist_ok=True)
        for name in names:
            cv2.imwrite(str(d / name), rng.integers(0, 256, (h, w, 3), np.uint8))
    return str(root)


def _reds_opt(tmp_path, lq_hw=(8, 10)):
    layout = {"000": [f"{i:08d}.png" for i in range(6)],
              "011": [f"{i:08d}.png" for i in range(4)]}
    return {"mode": "video_test", "N_frames": 3, "padding": "new_info", "scale": 4,
            "dataroot_LQ": _write_tree(tmp_path / "LQ", layout, *lq_hw, seed=1),
            "dataroot_GT": _write_tree(tmp_path / "GT", layout, 4 * lq_hw[0], 4 * lq_hw[1],
                                       seed=2)}


def _vimeo_opt(tmp_path, lq_hw=(8, 10)):
    layout = {f"0000{s}/000{q}": [f"im{i}.png" for i in range(1, 8)]
              for s, q in ((1, 1), (1, 2), (2, 7))}
    return {"mode": "Vimeo90K_test", "N_frames": 3, "padding": "new_info", "scale": 4,
            "dataroot_LQ": _write_tree(tmp_path / "LQv", layout, *lq_hw, seed=3),
            "dataroot_GT": _write_tree(tmp_path / "GTv", layout, 4 * lq_hw[0], 4 * lq_hw[1],
                                       seed=4)}


@pytest.mark.parametrize("kind", ["reds", "vimeo"])
def test_test_set_items_match_jax(tmp_path, kind):
    """create_dataset dispatches on `mode`; every item (window of LQ frames,
    GT centre, folder, idx, border) equals the JAX dataset's exactly. Vimeo
    nested septuplets give one centre-only item each."""
    opt = (_reds_opt if kind == "reds" else _vimeo_opt)(tmp_path)
    ours = create_dataset(opt)
    ref = (jax_datasets.VideoTestDataset if kind == "reds"
           else jax_datasets.Vimeo90KTestDataset)(opt)
    assert type(ours) is (datasets.VideoTestDataset if kind == "reds"
                          else datasets.Vimeo90KTestDataset)
    assert ours.names == ref.names and len(ours) == len(ref) == (10 if kind == "reds" else 3)
    assert ours.center_only == (kind == "vimeo")
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) and all(a[k] == b[k] for k in ("folder", "idx", "border"))
        np.testing.assert_array_equal(a["LQs"], b["LQs"])
        np.testing.assert_array_equal(a["GT"], b["GT"])


def _centre_upsample(windows):
    """A fixed numpy 'network': the centre frame, nearest x4."""
    c = np.asarray(windows)[:, windows.shape[1] // 2]
    return c.repeat(4, axis=1).repeat(4, axis=2)


@pytest.mark.parametrize("kind", ["reds", "vimeo"])
def test_evaluate_dataset_matches_jax(tmp_path, kind):
    """Per-clip (per-septuplet) PSNR / SSIM lists, frame counts and the
    average equal JAX's harness exactly with the same numpy infer_fn, in
    the whole-clip and the centre-only branch; a sequence-mode seq_fn
    computing the same frames gives the same results."""
    opt = (_reds_opt if kind == "reds" else _vimeo_opt)(tmp_path)
    ours = evaluate_dataset(_centre_upsample, create_dataset(opt), n_frames=3,
                            padding="new_info", chunk=4, ycbcr=True)
    ref_set = (jax_datasets.VideoTestDataset if kind == "reds"
               else jax_datasets.Vimeo90KTestDataset)(opt)
    ref = jax_evaluate_dataset(_centre_upsample, ref_set, n_frames=3, padding="new_info",
                               chunk=4, ycbcr=True)
    assert set(ours) == set(ref)
    for k in ref:
        assert dict(ours[k]) == dict(ref[k]), k
    if kind == "reds":
        seq = evaluate_dataset(None, create_dataset(opt), n_frames=3, padding="new_info",
                               ycbcr=True, seq_fn=lambda f, w: _centre_upsample(f[w]))
        assert {k: dict(v) for k, v in seq.items()} == {k: dict(v) for k, v in ours.items()}


def test_a_clip_without_gt_is_scored_by_nobody(tmp_path):
    """The port's rule, not JAX's KeyError: a clip without GT frames is
    super-resolved and not scored, and the average covers the others."""
    opt = _reds_opt(tmp_path)
    for f in Path(opt["dataroot_GT"], "011").iterdir():
        f.unlink()
    Path(opt["dataroot_GT"], "011").rmdir()
    test_set = create_dataset(opt)
    assert test_set.has_gt("000") and not test_set.has_gt("011") and "GT" not in test_set[7]
    res = evaluate_dataset(_centre_upsample, test_set, n_frames=3, padding="new_info")
    assert res["011"]["frames"] == 4 and "psnr_avg" not in res["011"]
    assert res["_avg"]["psnr_avg"] == res["000"]["psnr_avg"]


# ------------------------------------------------------------ checkpoints
def _tiny_edvr(seed):
    torch.manual_seed(seed)
    return EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)


def test_save_and_load_network_round_trip(tmp_path):
    """save_network writes <it>_<label>.pth (a plain state_dict);
    load_network restores it exactly; latest_checkpoint_iter finds the
    newest iteration of a label; load_pretrained takes the port's file and
    a reference-style `.pt` ({'state_dict': ...} with `module.` prefixes)."""
    a, b = _tiny_edvr(0), _tiny_edvr(1)
    path = save_network(str(tmp_path / "models"), 100, a)
    assert path.endswith("100_G.pth")
    save_network(str(tmp_path / "models"), 2000, b)
    save_network(str(tmp_path / "models"), 5000, b, label="E")
    assert latest_checkpoint_iter(str(tmp_path / "models")) == 2000
    assert latest_checkpoint_iter(str(tmp_path / "models"), "E") == 5000
    assert latest_checkpoint_iter(str(tmp_path / "none")) is None
    load_network(path, b)
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    pt = tmp_path / "ref.pt"
    torch.save({"state_dict": {"module." + k: v for k, v in _tiny_edvr(2).state_dict().items()}},
               pt)
    load_pretrained(b, str(pt))
    for k, v in _tiny_edvr(2).state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)


def test_non_strict_load_keeps_the_model_where_shapes_differ(tmp_path):
    """strict=False (path.strict_load: false) loads the entries whose shapes
    match and leaves the others at the model's values, as JAX's pick does;
    strict raises on the mismatch. An MFDN of 3 frames into one of 5:
    body0.weight, out.weight and out.bias differ, the rest loads."""
    torch.manual_seed(0)
    src, dst = MFDN(nf=8, nframes=3), MFDN(nf=8, nframes=5)
    keep = {k: v.clone() for k, v in dst.state_dict().items()}
    path = save_network(str(tmp_path), 1, src, label="E")
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_network(path, dst)
    load_network(path, dst, strict=False)
    for k, v in dst.state_dict().items():
        differ = k in ("body0.weight", "out.weight", "out.bias")
        want = keep[k] if differ else src.state_dict()[k]
        torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
    opt = {"network_G": {"which_model_G": "MFDN", "nf": 8, "nframes": 5},
           "path": {"pretrain_model_G": path, "strict_load": False}}
    model = VideoBaseModel(opt, device="cpu")
    torch.testing.assert_close(model.netG.down.weight, src.down.weight, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="size mismatch"):
        VideoBaseModel({**opt, "path": {"pretrain_model_G": path}}, device="cpu")


def test_what_the_port_still_refuses_says_why(tmp_path):
    """Only orbax checkpoint directories, second-order meta-training where
    the port has no double-backward kernels (bf16 DUF and EDVR: the
    second-order kernels take fp32), multi-process launchers and eval.tile
    raise, each naming its ROADMAP
    item and the reason. An LMDB root now reads: a test set over one (raw
    frames with their .meta, the port's writer) gives JAX's items; the
    meta-training dataset modes build MetaVideoDataset."""
    from dynavsr_tpu_torch.cli import train as train_cli
    from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter

    net = _tiny_edvr(0)
    (tmp_path / "100_G").mkdir()
    for ckpt in (tmp_path / "100_G", tmp_path / "DynaVSR_EDVR_M.ckpt"):
        with pytest.raises(NotImplementedError, match="orbax.*tensorstore.*A.2"):
            load_pretrained(net, str(ckpt))
    frames = (np.random.default_rng(0).random((4, 6, 5, 3)) * 255).astype(np.uint8)
    lmdb = str(tmp_path / "x.lmdb")
    with LmdbWriter(lmdb) as w:
        for i, f in enumerate(frames):
            w.put(f"clip_{i:08d}".encode(), f.tobytes())
            w.put(f"clip_{i:08d}.meta".encode(), b"6x5x3")
    opt = {"mode": "video_test", "dataroot_LQ": lmdb, "N_frames": 3}
    ours, theirs = create_dataset(opt), jax_datasets.VideoTestDataset(opt)
    assert len(ours) == len(theirs) == 4
    for i in range(4):
        np.testing.assert_array_equal(ours[i]["LQs"], theirs[i]["LQs"])
    np.testing.assert_array_equal(ours.clip_frames("clip"), frames[..., ::-1] / np.float32(255))
    from dynavsr_tpu_torch.data.datasets import MetaVideoDataset

    for mode in ("meta", "meta_learner", "MetaREDS", "MetaVimeo"):
        assert isinstance(create_dataset({"mode": mode, "dataroot_GT": lmdb, "N_frames": 3}),
                          MetaVideoDataset)
    with pytest.raises(NotImplementedError, match="not recognized"):
        create_dataset({"mode": "Kinetics", "dataroot_LQ": str(tmp_path)})
    with pytest.raises(NotImplementedError, match="second-order.*DUF.*A.7"):
        create_model({"model": "video_meta", "network_G": {"which_model_G": "DUF_16L",
                                                            "dtype": "bfloat16"},
                      "train": {"first_order": False}}, device="cpu")
    with pytest.raises(NotImplementedError, match="bfloat16.*A.7"):
        create_model({"model": "video_meta", "network_G": {
            "which_model_G": "EDVR", "nf": 8, "nframes": 3, "groups": 2, "front_RBs": 1,
            "back_RBs": 1, "dtype": "bfloat16"}}, device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed.*A.6"):
        train_cli.main(["-opt", "unused.yml", "--launcher", "pytorch"])
    with pytest.raises(NotImplementedError, match="eval.tile"):
        VideoBaseModel({"network_G": {"which_model_G": "MFDN", "nf": 8}, "eval": {"tile": 64}},
                       device="cpu")


CONFIGS = sorted((ROOT / "configs" / "test").glob("*.yml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_every_test_config_builds_in_the_port(path):
    """Each configs/test/*.yml: its network_G (and network_E) builds through
    define_G on the CPU as the architecture it names, its dataset block
    dispatches (the data root is absent
    here, so the set raises for the missing files, past the dispatch), and
    its checkpoint path goes to the loader that reads it or to the orbax
    refusal."""
    pytest.importorskip("yaml")
    opt = parse(str(path))
    net = define_G(opt, device="cpu")
    assert net.arch == {"EDVR": "EDVR", "TOF": "TOF"}.get(
        opt["network_G"]["which_model_G"], "DUF")
    if opt.get("network_E"):
        est = build_estimator(opt["network_E"], opt["scale"], opt["network_G"]["nframes"],
                              device="cpu")
        assert type(est).__name__ == opt["network_E"]["which_model_G"]
    for dataset_opt in opt["datasets"].values():
        with pytest.raises(FileNotFoundError):
            create_dataset(dataset_opt)
    ckpt = opt["path"]["pretrain_model_G"]
    with pytest.raises(NotImplementedError if ckpt.endswith(".ckpt") else FileNotFoundError):
        load_pretrained(net, ckpt)
