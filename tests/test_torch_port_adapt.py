"""The port's adapt-and-infer loop against the JAX loop, on CPU.

Tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 residual blocks) and MFDN (nf 8)
with JAX-initialised weights carried over by convert/from_jax.py; a 6-frame
16x20 clip; 2 Adam steps at lr 1e-3 (at the product's 1e-6 the weight
change is below fp32 noise). Compared: the first step's gradient of every
parameter, the per-step losses and the adapted SR frames, window-batched
and sequence mode, through cli/test_dynavsr.run_clip on the port's side.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
from dynavsr_tpu.adapt.adaptation import make_adapt_and_infer as jax_adapt_and_infer
from dynavsr_tpu.adapt.adaptation import make_adapt_and_infer_seq as jax_adapt_and_infer_seq
from dynavsr_tpu.data.windows import all_windows
from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.train.losses import charbonnier_loss as jax_charbonnier
from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_fn
from dynavsr_tpu_torch.cli.test_dynavsr import run_clip
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.downscaler import MFDN
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from torch_one_thread import one_thread  # noqa: F401

CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
T, H, W, N_ADAPT = 6, 16, 20, 4
STEPS, LR = 2, 1e-3


def _load(model, params):
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params), model.state_dict())
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    lq = rng.random((T, H, W, 3)).astype(np.float32)
    vsr_j, est_j = JaxEDVR(**CFG), JaxMFDN(scale=4, nf=8)
    vsr_p = jax.jit(vsr_j.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, H, W, 3)))
    est_p = jax.jit(est_j.init)(jax.random.PRNGKey(1), jnp.zeros((1, 3, H, W, 3)))
    # Non-zero offset convs, so adaptation moves real sampling positions.
    vsr_p = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + (0.05 * rng.standard_normal(a.shape)).astype(
            np.float32) if "conv_offset_mask" in jax.tree_util.keystr(path) else np.asarray(a),
        vsr_p)
    win = all_windows(T, 3, "reflection")
    adapt_windows = jnp.asarray(lq[win[:N_ADAPT]])
    slr = jax.jit(est_j.apply)(est_p, adapt_windows)
    return dict(lq=lq, win=win, vsr_j=vsr_j, vsr_p=vsr_p, est_p=est_p, slr=slr,
                lr_centers=adapt_windows[:, 1],
                vsr=_load(EDVR(**CFG), vsr_p), est=_load(MFDN(scale=4, nf=8, nframes=3), est_p))


def test_first_step_gradients_match_jax(setup):
    """Every parameter's gradient of the mean Charbonnier loss on the
    mod-padded SLR windows; 1e-5 of the largest gradient."""
    s = setup
    apply_j = jax_model_apply(s["vsr_j"], "EDVR", 4)
    grads_j = jax.jit(jax.grad(lambda p: jax_charbonnier(
        apply_j(p, s["slr"]), s["lr_centers"], reduction="mean")))(s["vsr_p"])
    grads_j = jax_params_to_state_dict(jax.tree.map(np.asarray, grads_j))

    model = copy.deepcopy(s["vsr"])
    from dynavsr_tpu_torch.train.losses import charbonnier_loss

    pred = make_model_apply("EDVR", 4)(model, torch.tensor(np.asarray(s["slr"])))
    charbonnier_loss(pred, torch.tensor(np.asarray(s["lr_centers"])),
                     reduction="mean").backward()
    grads_t = dict(model.named_parameters())
    assert set(grads_t) == set(grads_j)
    scale = max(float(g.abs().max()) for g in grads_j.values())
    for k, g in grads_j.items():
        np.testing.assert_allclose(grads_t[k].grad.numpy(), g.numpy(), atol=1e-5 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("seq", [False, True], ids=["windows", "seq"])
def test_adapt_and_infer_matches_jax(setup, seq):
    """MFDN -> 2 Adam steps -> inference over all 6 windows. Losses 1e-5
    relative; SR 1e-5 absolute, well under what adaptation changed it by
    (checked). Adam's first step is lr * sign(grad), so this holds only
    while no gradient sits at fp32 noise level, as here."""
    s = setup
    jcfg = JaxAdaptConfig(n_steps=STEPS, lr=LR, infer_chunk=4)
    apply_j = jax_model_apply(s["vsr_j"], "EDVR", 4)
    if seq:
        run = jax_adapt_and_infer_seq(s["vsr_j"], jcfg, jit=True, apply_fn=apply_j)
        sr_j, losses_j = run(s["vsr_p"], s["slr"], s["lr_centers"], jnp.asarray(s["lq"]),
                             jnp.asarray(s["win"]))
    else:
        run = jax_adapt_and_infer(s["vsr_j"], jcfg, jit=True, apply_fn=apply_j)
        sr_j, losses_j = run(s["vsr_p"], s["slr"], s["lr_centers"],
                             jnp.asarray(s["lq"][s["win"]]))
    cfg = AdaptConfig(n_steps=STEPS, lr=LR, infer_chunk=4)
    sr, res = run_clip(s["vsr"], s["est"], s["lq"], None, cfg, seq=seq, n_frames=3,
                       padding="reflection", n_adapt=N_ADAPT, device="cpu")
    np.testing.assert_allclose(res["adapt_losses"], np.asarray(losses_j), rtol=1e-5)
    assert res["adapt_losses"][1] < res["adapt_losses"][0]
    np.testing.assert_allclose(sr, np.asarray(sr_j), atol=1e-5)
    with torch.no_grad():
        unadapted = s["vsr"](torch.tensor(s["lq"][s["win"]])).numpy()
    assert np.abs(unadapted - sr).max() > 1e-3


def test_adapting_one_clip_leaves_the_meta_weights_alone(setup):
    """Clip A's adaptation must not carry into clip B: the meta module is
    unchanged and clip B adapts from the same start as a fresh run."""
    s = setup
    before = {k: v.clone() for k, v in s["vsr"].state_dict().items()}
    adapt = make_adapt_fn(AdaptConfig(n_steps=STEPS, lr=LR), make_model_apply("EDVR", 4))
    slr = torch.tensor(np.asarray(s["slr"]))
    centers = torch.tensor(np.asarray(s["lr_centers"]))
    adapted_a, losses_a = adapt(s["vsr"], slr, centers)
    for k, v in s["vsr"].state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    assert any(not torch.equal(p, before[k]) for k, p in adapted_a.state_dict().items())
    _, losses_b = adapt(s["vsr"], slr, centers)
    torch.testing.assert_close(losses_b, losses_a, rtol=0, atol=0)
