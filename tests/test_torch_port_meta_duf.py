"""Second-order meta-training of DUF-16L: the port (train/meta.py,
MetaModel, cli.train_dynavsr) against the JAX package's
(dynavsr_tpu/train/meta.py), on CPU. The checks and their tolerances are
test_torch_port_meta_tof.py's, whose helpers this file shares; kept apart
so that the two nets' JAX compiles run in different workers.

DUF-16L (3 + 3 dense layers) as train_DynaVSR_DUF_Vimeo90K.yml builds it,
7 frames, the JAX init carried to the port; a batch of 2 windows: SLR 4x4,
LR 16x16, HR 64x64. Its BatchNorms' running statistics get meta gradients
and take Adam's step, as in JAX.

- The meta gradient at alpha 0.1, first and second order: the parameters'
  and the running statistics' gradients each within 1e-3 relative norm of
  JAX's, and the two orders apart by more than 10 times that (measured 1.4
  to 4.3e-2). Not TOF's elementwise bound: at these sizes DUF's fp32
  gradients are ill-conditioned in both frameworks (ReLU inputs within
  float rounding of zero, as test_torch_port_train.py found for DUF's
  residual head): against a float64 evaluation of the port on the same
  weights, both frameworks' fp32 meta gradients are off by about as much
  as they are off each other, single entries by several 1e-5 of the
  largest gradient value.
- Two second-order Adam steps, MetaModel from a fed batch, as for TOF;
  grad_norm within 1e-3 relative (the gradients' bound above).
- One meta update through DufFilterFunction with counting plain stand-ins:
  K6 5 (4 forwards and the filter tangent K6(x, Cf)), K7 3, the launches
  chip_smoke.py phase 11 checks on the card.
- cli.train_dynavsr on DUF-16L with a frozen 7-frame MFDN (nf 8), resumed
  bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.duf import DUF as JaxDUF
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models import duf as duf_module
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.video_base_model import MetaModel, create_model
from dynavsr_tpu_torch.ops import duf_filter
from dynavsr_tpu_torch.train.checkpoint import save_network
from dynavsr_tpu_torch.train.meta import meta_variables
from test_torch_port_meta_tof import (
    STATS,
    check_meta_grads,
    check_metrics,
    check_stepped,
    cli_resumes_bitwise,
    count_launches,
    jax_meta_grads,
    jax_second_order_steps,
    meta_batches,
    port_meta_grad,
    port_second_order_steps,
)
from torch_one_thread import one_thread  # noqa: F401

ALPHA, LR, STEPS, FRAMES = 0.1, 1e-4, 2, 7
DUF_LAUNCHES = {"duf_fwd": 5, "duf_bwd": 3}


@pytest.fixture(scope="module")
def setup():
    jax_model = JaxDUF(dense1_layers=3)
    batches = meta_batches(FRAMES, STEPS, seed=0)
    v = jax.tree.map(np.asarray, jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                         jnp.asarray(batches[0]["LR"])))
    apply = jax_model_apply(jax_model, "DUF_16L", 4)
    return dict(jax_model=jax_model, variables=v, batches=batches, jax_apply=apply,
                jax_grads=jax_meta_grads(jax_model, apply, v, batches[0], ALPHA))


def _port_net(setup):
    net = DUF(dense1_layers=3)
    net.load_state_dict(jax_params_to_state_dict(setup["variables"], net.state_dict()))
    return net.eval()


@pytest.mark.parametrize("first_order", [True, False], ids=["first_order", "second_order"])
def test_duf_meta_gradient_matches_jax(setup, first_order):
    net = _port_net(setup)
    got = port_meta_grad(net, setup["batches"][0], ALPHA, first_order)
    check_meta_grads(net, got, setup["jax_grads"], first_order, rel_norm=1e-3)


@pytest.fixture(scope="module")
def jax_steps(setup):
    return jax_second_order_steps(setup["jax_model"], setup["jax_apply"], setup["variables"],
                                  setup["batches"], ALPHA)


def test_duf_two_second_order_meta_steps_match_jax(setup, jax_steps):
    net = _port_net(setup)
    metrics = port_second_order_steps(net, setup["batches"], ALPHA)
    for got, want in zip(metrics, jax_steps[0]):
        check_metrics(got, want, grad_norm_rel=1e-3)
    check_stepped(net, setup["variables"], jax_steps[1], [LR] * STEPS)


def test_duf_meta_model_with_a_fed_batch_matches_jax(setup, jax_steps, tmp_path):
    save_network(str(tmp_path), 0, _port_net(setup))
    opt = {"name": "meta", "model": "video_meta", "scale": 4, "is_train": True,
           "network_G": {"which_model_G": "DUF_16L", "nframes": FRAMES},
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
    check_metrics(model.get_current_log(), jax_steps[0][0], grad_norm_rel=1e-3)
    start = jax_params_to_state_dict(setup["variables"])
    sd = model.netG.state_dict()
    assert all(not torch.equal(sd[k], start[k]) for k in sd if k.endswith(STATS))


def test_duf_meta_update_launches_with_the_kernel_stand_ins(monkeypatch):
    from test_torch_port_double_backward import _stand_ins

    _stand_ins("duf", monkeypatch)
    calls = count_launches(duf_filter, DUF_LAUNCHES, monkeypatch)
    monkeypatch.setattr(duf_module, "dynamic_upsampling_filter",
                        duf_filter.DufFilterFunction.apply)
    torch.manual_seed(0)
    net = DUF(dense1_layers=3).eval()
    metrics = port_second_order_steps(net, meta_batches(FRAMES, 1, seed=1), 1e-3)
    assert dict(calls) == DUF_LAUNCHES
    assert all(np.isfinite(v) for v in metrics[0].values())


def test_duf_train_dynavsr_cli_resumes_bitwise(tmp_path):
    cli_resumes_bitwise(tmp_path, "meta_duf", "{which_model_G: DUF_16L, nframes: 7}", FRAMES)
