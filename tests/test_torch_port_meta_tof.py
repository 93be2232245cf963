"""Second-order meta-training of TOFlow: the port (train/meta.py, MetaModel,
cli.train_dynavsr) against the JAX package's (dynavsr_tpu/train/meta.py),
on CPU.

TOFlow with the in-module bicubic pre-upscale (`pre_upscale`, as
train_DynaVSR_TOF_Vimeo90K.yml sets it), 3 frames, the JAX init carried to
the port with jax_params_to_state_dict. The JAX side runs its plain conv
schedule (`s2d=False`): the space-to-depth schedule computes the same
output and compiles ~5x slower on CPU. A batch of 2 windows, numpy from a
seed: SLR 4x4 (pre-upscaled 16x16), LR 16x16 (64x64), HR 64x64. Both
forwards go through each side's make_model_apply, the net in eval mode.

What is differentiated is JAX's: its meta step takes the gradient over the
whole variables dict, so SpyNet's BatchNorm running means and variances
get meta gradients, move by the inner SGD step and take Adam's step.

- The meta gradient at alpha 1, first and second order, in every parameter
  and every running statistic: within 1e-5 of the largest gradient value
  (fp32 sums in another order; measured ~4e-6 of it); the statistics also
  within 1e-3 of their own largest gradient. The two orders differ by more
  than 100 times the tolerance: a dropped second-order term shows.
- Two second-order Adam steps of make_meta_train_step (lr 1e-4, constant)
  on the variables: l_outer and l_inner 1e-5 relative, grad_norm 1e-4;
  every parameter within 2 x (the sum of the updates' lr) plus 1e-5
  relative (test_torch_port_train.py's bound); and since Adam moves every
  entry by about lr whatever its gradient, the running statistics are held
  by how they moved: their mean difference from JAX's below 5 % of their
  mean change (a port that left them in place would be 100 % off).
- MetaModel (create_model, model: video_meta, first_order false) from a
  .pth of the same weights, fed the batch as numpy: its first update's log
  is JAX's, and its running statistics moved as JAX's did.
- One meta update at train_DynaVSR_TOF_Vimeo90K.yml's 7 frames through
  WarpFunction, its launchers replaced by plain stand-ins that count
  (test_torch_port_double_backward.py's): K4 120, K5 72, K11 = K12 = 24,
  the launches chip_smoke.py phase 11 checks on the card.
- cli.train_dynavsr on a TOF config with a frozen 3-frame MFDN (nf 8) in
  the loop, 4 iterations, then resumed from 2: losses and final weights
  (running statistics included) bitwise.
"""

import collections
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu.train import meta as jax_meta
from dynavsr_tpu.train.losses import charbonnier_loss as jax_charbonnier
from dynavsr_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dynavsr_tpu.train.trainer import TrainState
from dynavsr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter
from dynavsr_tpu_torch.models import tof as tof_module
from dynavsr_tpu_torch.models.downscaler import MFDN
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.tof import TOFlow
from dynavsr_tpu_torch.models.video_base_model import MetaModel, create_model
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.train.checkpoint import save_network
from dynavsr_tpu_torch.train.meta import (
    MetaConfig,
    make_meta_train_step,
    meta_loss,
    meta_variables,
)
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_schedule
from torch_one_thread import one_thread  # noqa: F401

ALPHA, LR, STEPS, FRAMES = 1.0, 1e-4, 2, 3
STATS = ("running_mean", "running_var")
# The warp launches of one second-order meta update with remat, 7 frames:
# 6 neighbours x 5 warps (4 SpyNet levels and the final one) in each of 4
# forwards (inner, its 2 recomputations, outer); K5 in 3 backwards of the 24
# warps whose flow is not the level-0 constant zero; K11 / K12 as one
# launch each (warp_bwd_tangent with T), so no launch of T alone.
TOF_LAUNCHES = {"warp_fwd": 120, "warp_bwd": 72, "warp_fwd_tangent": 0,
                "warp_bwd_tangent": 24}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def meta_batches(n_frames: int, steps: int, seed: int):
    """`steps` batches of 2 windows: SLR 4x4, LR 16x16, HR 64x64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        b = {"SLR": rng.random((2, n_frames, 4, 4, 3)).astype(np.float32),
             "LR": rng.random((2, n_frames, 16, 16, 3)).astype(np.float32),
             "HR_center": rng.random((2, 64, 64, 3)).astype(np.float32)}
        b["LR_center"] = b["LR"][:, n_frames // 2].copy()
        out.append(b)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_meta_grads(jax_model, apply, variables, batch, alpha):
    """JAX's meta gradient over the whole variables dict, by order."""
    out = {}
    for fo in (True, False):
        cfg = jax_meta.MetaConfig(inner_lr=alpha, first_order=fo)

        def loss(p, cfg=cfg):
            fast, _ = jax_meta.adapted_params(jax_model, p, batch["SLR"], batch["LR_center"],
                                              cfg, apply_fn=apply)
            return jax_charbonnier(apply(fast, batch["LR"]), batch["HR_center"],
                                   reduction="mean")

        out[fo] = _np(jax.jit(jax.grad(loss))(variables))
    return out


def port_meta_grad(net, batch, alpha, first_order):
    """The port's meta gradient in meta_variables(net), by name."""
    leaves = {k: t.detach().clone().requires_grad_() for k, t in meta_variables(net).items()}
    cfg = MetaConfig(inner_lr=alpha, first_order=first_order)
    outer, _ = meta_loss(net, leaves, torch_batch(batch), cfg, make_model_apply(net.arch, 4))
    return dict(zip(leaves, torch.autograd.grad(outer, list(leaves.values()))))


def check_meta_grads(net, got, jax_grads, first_order, rel_norm=None):
    """Parameters and statistics within 1e-5 of the largest gradient value,
    the statistics also within 1e-3 of their own largest; or, with
    `rel_norm`, the parameters' and the statistics' gradients each within
    that relative norm of JAX's. Either way the two orders are apart by more
    than 10 times the tolerance."""
    want = {o: jax_params_to_state_dict(jax_grads[o], net.state_dict()) for o in (True, False)}
    assert set(got) == {k for k in want[True] if not k.endswith("num_batches_tracked")}
    assert any(k.endswith(STATS) for k in got)
    if rel_norm is not None:
        for stats in (False, True):
            keys = [k for k in got if k.endswith(STATS) == stats]
            g, w, o = (torch.cat([d[k].flatten() for k in keys])
                       for d in (got, want[first_order], want[not first_order]))
            err, apart = float((g - w).norm() / w.norm()), float((o - w).norm() / w.norm())
            assert err <= rel_norm, (stats, err)
            assert apart > 10 * rel_norm, (stats, apart)
        return
    tol = 1e-5 * max(float(g.abs().max()) for g in want[first_order].values())
    stat_top = max(float(v.abs().max()) for k, v in want[first_order].items()
                   if k.endswith(STATS))
    for k, g in got.items():
        atol = min(tol, 1e-3 * stat_top) if k.endswith(STATS) else tol
        torch.testing.assert_close(g, want[first_order][k], rtol=0, atol=atol, msg=k)
    apart = max(float((want[False][k] - want[True][k]).abs().max()) for k in got)
    assert apart > 100 * tol, (apart, tol)


def jax_second_order_steps(jax_model, apply, variables, batches, alpha):
    """len(batches) second-order meta updates on JAX's side: (metrics, final
    variables)."""
    state = TrainState.create(apply_fn=jax_model.apply, params=variables,
                              tx=jax_make_optimizer(JaxTrainerConfig(lr=LR, scheme="constant")))
    step = jax_meta.make_meta_train_step(jax_model, jax_meta.MetaConfig(inner_lr=alpha),
                                         donate=False, apply_fn=apply)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _np(state.params)


def check_metrics(got, want, grad_norm_rel=1e-4):
    for k, rel in (("l_outer", 1e-5), ("l_inner", 1e-5), ("grad_norm", grad_norm_rel)):
        assert got[k] == pytest.approx(want[k], rel=rel), (k, got[k], want[k])


def check_stepped(net, start_variables, want_variables, lrs):
    """Every parameter within 2 x sum(lrs) + 1e-5 relative of JAX's; the
    running statistics moved, and their mean difference from JAX's is below
    5 % of their mean change."""
    start = jax_params_to_state_dict(start_variables)
    want = jax_params_to_state_dict(want_variables)
    got = net.state_dict()
    for k, v in want.items():
        if not k.endswith(STATS + ("num_batches_tracked",)):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=2 * sum(lrs), err_msg=k)
    keys = [k for k in want if k.endswith(STATS)]
    moved = np.mean(np.concatenate([(want[k] - start[k]).abs().flatten().numpy() for k in keys]))
    diff = np.mean(np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in keys]))
    assert moved > 0.5 * sum(lrs), moved
    assert diff < 0.05 * moved, (diff, moved)


def port_second_order_steps(net, batches, alpha):
    cfg = TrainerConfig(lr=LR, scheme="constant")
    opt = make_optimizer(cfg, list(meta_variables(net).values()))
    step = make_meta_train_step(net, MetaConfig(inner_lr=alpha), opt, make_schedule(cfg),
                                apply_fn=make_model_apply(net.arch, 4))
    return [{k: float(v) for k, v in step(torch_batch(b), i).items()}
            for i, b in enumerate(batches)]


def count_launches(module, names, monkeypatch):
    """Wrap each launcher of `module` so that it counts its calls."""
    calls = collections.Counter()
    for name in names:
        def counted(*args, fn=getattr(module, name), name=name, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return calls


def write_septuplets(path: str, clips: int, frames: int, seed: int) -> str:
    """Vimeo90K-shaped raw-byte LMDB entries ('<clip>_0001_<frame:08d>', BGR
    bytes and a '.meta' entry) of 48x56 smooth noise."""
    rng = np.random.default_rng(seed)
    with LmdbWriter(path) as w:
        for i in range(clips):
            base = rng.random((frames, 6, 7, 3)) * 255
            hr = np.repeat(np.repeat(base, 8, axis=1), 8, axis=2)
            u8 = np.clip(hr + rng.normal(0, 4, hr.shape), 0, 255).round().astype(np.uint8)
            for f, frame in enumerate(u8):
                key = f"{i + 1:05d}_0001_{f:08d}".encode()
                w.put(key, np.ascontiguousarray(frame).tobytes())
                w.put(key + b".meta", "x".join(map(str, frame.shape)).encode())
    return path


def meta_yml(tmp_path, name, net, frames, resume=None) -> str:
    body = f"""
        name: {name}
        model: video_meta
        scale: 4
        datasets:
          train:
            name: Vimeo90K_meta
            mode: meta
            dataroot_GT: {tmp_path / "sept.lmdb"}
            N_frames: {frames}
            GT_size: 48
            batch_size: 2
            n_workers: 2
        network_G: {net}
        network_E: {{which_model_G: MFDN, nf: 8}}
        path: {{root: {tmp_path}, resume_state: {resume or "~"},
                pretrain_model_E: {tmp_path / "est" / "0_G.pth"}}}
        train:
          lr_G: !!float 1e-4
          lr_scheme: constant
          beta1: 0.9
          beta2: 0.99
          niter: 4
          maml_lr_alpha: !!float 1e-3
          maml_adapt_iter: 1
          first_order: false
          pixel_criterion: cb
          manual_seed: 0
          val_freq: 1000
        logger: {{print_freq: 1, save_checkpoint_freq: 2}}
        """
    path = tmp_path / f"{name}{'_resume' if resume else ''}.yml"
    path.write_text(textwrap.dedent(body))
    return str(path)


def cli_resumes_bitwise(tmp_path, name, net, frames):
    """cli.train_dynavsr with a frozen MFDN (nf 8) for 4 iterations, then
    resumed from 2.state: the losses of iterations 3-4 and the final
    weights, running statistics included, bitwise."""
    from dynavsr_tpu_torch.cli import train_dynavsr

    write_septuplets(str(tmp_path / "sept.lmdb"), 4, frames, seed=0)
    torch.manual_seed(0)
    save_network(str(tmp_path / "est"), 0, MFDN(scale=4, nf=8, nframes=frames))
    exp = tmp_path / "experiments" / name
    assert train_dynavsr.main(["-opt", meta_yml(tmp_path, name, net, frames),
                               "--device", "cpu"]) == 4
    first = torch.load(exp / "models" / "4_G.pth", weights_only=True)
    start = torch.load(exp / "models" / "2_G.pth", weights_only=True)
    metrics = tmp_path / "tb_logger" / name / "metrics.jsonl"
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) and r[k] > 0 for r in recs for k in ("l_outer", "l_inner",
                                                                          "grad_norm"))
    resume = str(exp / "training_state" / "2.state")
    assert train_dynavsr.main(["-opt", meta_yml(tmp_path, name, net, frames, resume=resume),
                               "--device", "cpu"]) == 4
    again = [json.loads(line) for line in metrics.read_text().splitlines()][4:]
    assert [r["step"] for r in again] == [3, 4]
    assert [r["l_outer"] for r in again] == [r["l_outer"] for r in recs[2:]]
    second = torch.load(exp / "models" / "4_G.pth", weights_only=True)
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)
    stats = [k for k in first if k.endswith(STATS)]
    assert stats and all(not torch.equal(first[k], start[k]) for k in stats)


# ------------------------------------------------------------------ TOF
@pytest.fixture(scope="module")
def setup():
    jax_model = JaxTOFlow(pre_upscale=True, s2d=False)
    batches = meta_batches(FRAMES, STEPS, seed=0)
    v = _np(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0]["LR"])))
    apply = jax_model_apply(jax_model, "TOF", 4)
    return dict(jax_model=jax_model, variables=v, batches=batches, jax_apply=apply,
                jax_grads=jax_meta_grads(jax_model, apply, v, batches[0], ALPHA))


def _port_net(setup):
    net = TOFlow(pre_upscale=True, nframes=FRAMES)
    net.load_state_dict(jax_params_to_state_dict(setup["variables"], net.state_dict()))
    return net.eval()


@pytest.mark.parametrize("first_order", [True, False], ids=["first_order", "second_order"])
def test_tof_meta_gradient_matches_jax(setup, first_order):
    net = _port_net(setup)
    got = port_meta_grad(net, setup["batches"][0], ALPHA, first_order)
    check_meta_grads(net, got, setup["jax_grads"], first_order)


@pytest.fixture(scope="module")
def jax_steps(setup):
    return jax_second_order_steps(setup["jax_model"], setup["jax_apply"], setup["variables"],
                                  setup["batches"], ALPHA)


def test_tof_two_second_order_meta_steps_match_jax(setup, jax_steps):
    net = _port_net(setup)
    metrics = port_second_order_steps(net, setup["batches"], ALPHA)
    for got, want in zip(metrics, jax_steps[0]):
        check_metrics(got, want)
    check_stepped(net, setup["variables"], jax_steps[1], [LR] * STEPS)


def test_tof_meta_model_with_a_fed_batch_matches_jax(setup, jax_steps, tmp_path):
    save_network(str(tmp_path), 0, _port_net(setup))
    opt = {"name": "meta", "model": "video_meta", "scale": 4, "is_train": True,
           "network_G": {"which_model_G": "TOF", "nframes": FRAMES, "pre_upscale": True},
           "path": {"pretrain_model_G": str(tmp_path / "0_G.pth"), "strict_load": True},
           "train": {"lr_G": LR, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                     "maml_lr_alpha": ALPHA, "maml_adapt_iter": 1, "first_order": False,
                     "pixel_criterion": "cb"}}
    model = create_model(opt, device="cpu")
    assert isinstance(model, MetaModel) and not model.meta_cfg.first_order
    held = {id(p) for g in model.optimizer.param_groups for p in g["params"]}
    assert all(id(t) in held for t in meta_variables(model.netG).values())
    model.feed_data(setup["batches"][0])
    model.optimize_parameters()
    check_metrics(model.get_current_log(), jax_steps[0][0])
    start = jax_params_to_state_dict(setup["variables"])
    sd = model.netG.state_dict()
    assert all(not torch.equal(sd[k], start[k]) for k in sd if k.endswith(STATS))


def test_tof_meta_update_launches_with_the_kernel_stand_ins(monkeypatch):
    """7 frames (the config's), SLR 4x4, LR 16x16, random weights."""
    from test_torch_port_double_backward import _stand_ins

    _stand_ins("warp", monkeypatch)
    calls = count_launches(warp, TOF_LAUNCHES, monkeypatch)
    monkeypatch.setattr(tof_module, "warp_nchw", warp.WarpFunction.apply)
    torch.manual_seed(0)
    net = TOFlow(pre_upscale=True, nframes=7).eval()
    metrics = port_second_order_steps(net, meta_batches(7, 1, seed=1), 1e-3)
    assert {k: calls[k] for k in TOF_LAUNCHES} == TOF_LAUNCHES
    assert all(np.isfinite(v) for v in metrics[0].values())


def test_tof_train_dynavsr_cli_resumes_bitwise(tmp_path):
    cli_resumes_bitwise(tmp_path, "meta_tof", "{which_model_G: TOF, nframes: 3, "
                                              "pre_upscale: true}", 3)
