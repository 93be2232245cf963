"""The port's meta-training (train/meta.py, MetaModel) against the JAX
package's (dynavsr_tpu/train/meta.py), on CPU.

A tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 blocks; the JAX init with its
offset convs redrawn N(0, 0.05) so the DCNs sample off the grid) carried to
the port with jax_params_to_state_dict; a batch of 2 windows: SLR 5x5 (not
divisible by 4, so both sides mod-pad it), LR 20x20, HR 80x80, numpy from
a seed. Both forwards run through each side's make_model_apply.

- The fast weights of one inner step and the inner loss: (theta - fast) /
  alpha, the inner gradient, within 1e-5 of its largest value; the loss
  1e-6 relative.
- The meta gradient at alpha 1, first and second order: each parameter
  within 1e-5 of the largest gradient value (fp32 sums in another order;
  measured ~1e-7 of it). At this alpha the second-order part of the
  gradient is ~5e-3 of its largest value, so the two orders differ by more
  than 100 times the tolerance: a dropped term shows.
- Two Adam steps of make_meta_train_step (lr 1e-4, constant): l_outer and
  l_inner 1e-5 relative, grad_norm 1e-4 relative, and every parameter
  within 2 x (the sum of the updates' lr) absolute plus 1e-5 relative (the
  bound of test_torch_port_train.py: where a gradient is float noise
  around zero, Adam may step it either way).
- use_remat (torch.utils.checkpoint) on and off give the same second-order
  meta gradient (1e-6 of its largest value).
- MetaModel, fed the batch as numpy, takes the same first step as JAX's
  second-order step; EDVR, TOF and DUF build to second order in fp32 and
  bf16 (test_torch_port_meta_tof.py / _duf.py hold TOF / DUF against JAX,
  test_torch_port_bf16_second_order.py a bf16 EDVR-L-shaped net).
- One meta update through DeformConv2dFunction, its launchers replaced by
  plain stand-ins that count (test_torch_port_double_backward.py's), makes
  the launches chip_smoke.py phase 10 checks on the card.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.train import meta as jax_meta
from dynavsr_tpu.train.losses import charbonnier_loss as jax_charbonnier
from dynavsr_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dynavsr_tpu.train.trainer import TrainState
from dynavsr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.video_base_model import MetaModel, create_model
from dynavsr_tpu_torch.ops import dcn
from dynavsr_tpu_torch.train.checkpoint import save_network
from dynavsr_tpu_torch.train.meta import MetaConfig, adapted_params, make_meta_train_step, meta_loss
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_schedule
from torch_one_thread import one_thread  # noqa: F401

CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
ALPHA, LR, STEPS = 1.0, 1e-4, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxEDVR(**CFG)
    v = _np(jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3))))
    rng = np.random.default_rng(0)

    def redraw(tree):
        for k, leaf in tree.items():
            if k == "conv_offset_mask":
                leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05
                                  ).astype(np.float32)
            elif isinstance(leaf, dict):
                redraw(leaf)

    redraw(v["params"])
    batches = []
    for _ in range(STEPS):
        b = {"SLR": rng.random((2, 3, 5, 5, 3)).astype(np.float32),
             "LR": rng.random((2, 3, 20, 20, 3)).astype(np.float32),
             "HR_center": rng.random((2, 80, 80, 3)).astype(np.float32)}
        b["LR_center"] = b["LR"][:, 1].copy()
        batches.append(b)
    return dict(jax_model=jax_model, variables=v, batches=batches,
                jax_apply=jax_model_apply(jax_model, "EDVR", 4))


def _port_net(setup):
    net = EDVR(**CFG)
    net.load_state_dict(jax_params_to_state_dict(setup["variables"], net.state_dict()))
    return net


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_adapted_params_match_jax(setup):
    """One inner SGD step (alpha 1): the inner gradient and loss."""
    b, jm = setup["batches"][0], setup["jax_model"]
    cfg = jax_meta.MetaConfig(inner_lr=ALPHA)
    fast, loss = jax.jit(lambda p: jax_meta.adapted_params(
        jm, p, b["SLR"], b["LR_center"], cfg, apply_fn=setup["jax_apply"]))(setup["variables"])
    net = _port_net(setup)
    params = dict(net.named_parameters())
    got, got_loss = adapted_params(net, params, torch.from_numpy(b["SLR"]),
                                   torch.from_numpy(b["LR_center"]), MetaConfig(inner_lr=ALPHA),
                                   make_model_apply("EDVR", 4))
    want = jax_params_to_state_dict(_np(fast), net.state_dict())
    start = net.state_dict()
    g_want = {k: (start[k] - want[k]) / ALPHA for k in params}
    g_got = {k: (params[k] - got[k]).detach() / ALPHA for k in params}
    top = max(float(g.abs().max()) for g in g_want.values())
    for k in params:
        torch.testing.assert_close(g_got[k], g_want[k], rtol=0, atol=1e-5 * top, msg=k)
    assert float(got_loss.detach()) == pytest.approx(float(loss), rel=1e-6)


def _jax_meta_grad(setup, batch, first_order):
    jm, apply = setup["jax_model"], setup["jax_apply"]
    cfg = jax_meta.MetaConfig(inner_lr=ALPHA, first_order=first_order)

    def loss(p):
        fast, _ = jax_meta.adapted_params(jm, p, batch["SLR"], batch["LR_center"], cfg,
                                          apply_fn=apply)
        return jax_charbonnier(apply(fast, batch["LR"]), batch["HR_center"], reduction="mean")

    return _np(jax.jit(jax.grad(loss))(setup["variables"]))


def _port_meta_grad(net, batch, first_order, use_remat=True):
    params = dict(net.named_parameters())
    cfg = MetaConfig(inner_lr=ALPHA, first_order=first_order, use_remat=use_remat)
    outer, _ = meta_loss(net, params, _torch(batch), cfg, make_model_apply("EDVR", 4))
    return dict(zip(params, torch.autograd.grad(outer, list(params.values()))))


@pytest.fixture(scope="module")
def jax_grads(setup):
    return {fo: _jax_meta_grad(setup, setup["batches"][0], fo) for fo in (True, False)}


@pytest.mark.parametrize("first_order", [True, False], ids=["first_order", "second_order"])
def test_meta_gradient_matches_jax(setup, jax_grads, first_order):
    net = _port_net(setup)
    got = _port_meta_grad(net, setup["batches"][0], first_order)
    want = {o: jax_params_to_state_dict(jax_grads[o], net.state_dict()) for o in (True, False)}
    tol = 1e-5 * max(float(g.abs().max()) for g in want[first_order].values())
    for k, g in got.items():
        torch.testing.assert_close(g, want[first_order][k], rtol=0, atol=tol, msg=k)
    apart = max(float((want[False][k] - want[True][k]).abs().max()) for k in got)
    assert apart > 100 * tol, (apart, tol)


def test_use_remat_on_equals_off(setup):
    net = _port_net(setup)
    on = _port_meta_grad(net, setup["batches"][0], False, use_remat=True)
    off = _port_meta_grad(net, setup["batches"][0], False, use_remat=False)
    top = max(float(g.abs().max()) for g in off.values())
    for k in on:
        torch.testing.assert_close(on[k], off[k], rtol=0, atol=1e-6 * top, msg=k)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """STEPS meta updates on JAX's side, per order: (metrics, final params)."""
    out = {}
    for fo in (True, False):
        jcfg = JaxTrainerConfig(lr=LR, scheme="constant")
        state = TrainState.create(apply_fn=setup["jax_model"].apply, params=setup["variables"],
                                  tx=jax_make_optimizer(jcfg))
        step = jax_meta.make_meta_train_step(
            setup["jax_model"], jax_meta.MetaConfig(inner_lr=ALPHA, first_order=fo),
            donate=False, apply_fn=setup["jax_apply"])
        metrics = []
        for b in setup["batches"]:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out[fo] = (metrics, _np(state.params))
    return out


def _check_metrics(got, want):
    for k, rel in (("l_outer", 1e-5), ("l_inner", 1e-5), ("grad_norm", 1e-4)):
        assert got[k] == pytest.approx(want[k], rel=rel), (k, got[k], want[k])


@pytest.mark.parametrize("first_order", [True, False], ids=["first_order", "second_order"])
def test_two_meta_steps_match_jax(setup, jax_steps, first_order):
    net = _port_net(setup)
    cfg = TrainerConfig(lr=LR, scheme="constant")
    opt = make_optimizer(cfg, net.parameters())
    step = make_meta_train_step(net, MetaConfig(inner_lr=ALPHA, first_order=first_order), opt,
                                make_schedule(cfg), apply_fn=make_model_apply("EDVR", 4))
    want_metrics, want_params = jax_steps[first_order]
    for i, b in enumerate(setup["batches"]):
        _check_metrics({k: float(v) for k, v in step(_torch(b), i).items()}, want_metrics[i])
    want = jax_params_to_state_dict(want_params)
    got = net.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=2 * STEPS * LR,
                                   err_msg=k)


def _meta_opt(root, **net):
    return {"name": "meta", "model": "video_meta", "scale": 4, "is_train": True,
            "network_G": {"which_model_G": "EDVR", **CFG, **net},
            "path": {"pretrain_model_G": str(root / "0_G.pth"), "strict_load": True},
            "train": {"lr_G": LR, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                      "maml_lr_alpha": ALPHA, "maml_adapt_iter": 1, "first_order": False,
                      "pixel_criterion": "cb"}}


def test_meta_model_with_a_fed_batch_matches_jax(setup, jax_steps, tmp_path):
    """MetaModel (create_model, model: video_meta) from a .pth of the same
    weights: its first update's log is JAX's second-order step's."""
    save_network(str(tmp_path), 0, _port_net(setup))
    model = create_model(_meta_opt(tmp_path), device="cpu")
    assert isinstance(model, MetaModel) and not model.meta_cfg.first_order
    model.feed_data(setup["batches"][0])
    model.optimize_parameters(1)
    assert model.step == 1
    _check_metrics(model.get_current_log(), jax_steps[False][0][0])


def test_meta_model_builds_every_net_to_second_order_in_fp32_and_bf16(tmp_path):
    """EDVR, TOF and DUF build to second order in fp32 and in bf16 (the DCN's
    and the filter's second-order kernels take bf16; TOF's warps stay
    fp32), and to first order when the config asks for it; the bf16 EDVR's
    convs run in bf16."""
    save_network(str(tmp_path), 0, EDVR(**CFG))
    model = create_model(_meta_opt(tmp_path, dtype="bfloat16"), device="cpu")
    assert isinstance(model, MetaModel) and not model.meta_cfg.first_order
    assert model.netG.conv_first.compute_dtype == torch.bfloat16

    def meta(net, first_order=False):
        return {"name": "meta", "model": "video_meta", "scale": 4, "is_train": True,
                "network_G": net, "path": {}, "train": {"first_order": first_order}}

    tof, duf = {"which_model_G": "TOF", "nframes": 3}, {"which_model_G": "DUF_16L"}
    for net in (tof, duf, {**tof, "dtype": "bfloat16"}, {**duf, "dtype": "bfloat16"}):
        assert not create_model(meta(net), device="cpu").meta_cfg.first_order
    assert create_model(meta({**duf, "dtype": "bfloat16"}, True), device="cpu"
                        ).meta_cfg.first_order


def test_meta_update_launches_with_the_kernel_stand_ins(setup, monkeypatch):
    """A second-order meta update with remat (MetaConfig's defaults) makes
    K1 28, K2 24, K3 20 and K8 = K9 = K10 = 4 wrapper calls: 4 DCNs, each
    run in the inner forward, its two recomputations and the outer forward
    (K1), backward in the inner step, the outer step and through the inner
    forward again (K2, K3), and once through the double backward (K1 x3,
    K2 x3, K3 x2, K8-K10)."""
    from test_torch_port_double_backward import _stand_ins

    _stand_ins("dcn", monkeypatch)
    calls = collections.Counter()
    for name, kernel in (("_fwd", "dcn_fwd"), ("dcn_bwd_data", "dcn_bwd_data"),
                         ("dcn_bwd_weight", "dcn_bwd_weight"),
                         ("dcn_fwd_tangent", "dcn_fwd_tangent"),
                         ("dcn_bwd_weight_tangent", "dcn_bwd_weight_tangent"),
                         ("dcn_bwd_data_tangent", "dcn_bwd_data_tangent")):
        def counted(*args, fn=getattr(dcn, name), kernel=kernel):
            calls[kernel] += 1
            return fn(*args)
        monkeypatch.setattr(dcn, name, counted)
    monkeypatch.setattr(edvr_module, "deform_conv2d",
                        lambda x, o, m, w, b=None, deformable_groups=1:
                        dcn.DeformConv2dFunction.apply(x, o, m, w, b, deformable_groups))
    net = _port_net(setup)
    cfg = TrainerConfig(lr=LR, scheme="constant")
    step = make_meta_train_step(net, MetaConfig(inner_lr=ALPHA), make_optimizer(
        cfg, net.parameters()), make_schedule(cfg), apply_fn=make_model_apply("EDVR", 4))
    metrics = step(_torch(setup["batches"][0]), 0)
    assert dict(calls) == {"dcn_fwd": 28, "dcn_bwd_data": 24, "dcn_bwd_weight": 20,
                           "dcn_fwd_tangent": 4, "dcn_bwd_weight_tangent": 4,
                           "dcn_bwd_data_tangent": 4}
    assert all(np.isfinite(float(v)) for v in metrics.values())
