"""The plain reference against the port's CPU path at a tiny size: EDVR,
MFDN, the bicubic resize, one adaptation step and one meta step, from the
same tensors (CPU only; the port's CPU path runs its plain DCN)."""

import pytest
import torch

from benchmark import inputs
from benchmark.reference import adapt as ref_adapt
from benchmark.reference import meta as ref_meta
from benchmark.reference import nets

ARCH = {"nf": 8, "nframes": 5, "groups": 2, "front_RBs": 1, "back_RBs": 1}
CFG = {"network_G": ARCH, "network_E": {"nf": 8}, "scale": 4}
Q = nets.rounding("none")


@pytest.fixture(scope="module")
def tensors():
    torch.manual_seed(0)
    return (inputs.make_params(inputs.vsr_spec(CFG), 11, "weights_vsr", "cpu"),
            inputs.make_params(inputs.est_spec(CFG), 11, "weights_est", "cpu"))


def _edvr(p):
    from dynavsr_tpu_torch.models.edvr import EDVR
    net = EDVR(**ARCH)
    net.load_state_dict(p, strict=True)
    return net.eval()


def _frames(*shape, seed=1):
    return inputs.sinusoids(inputs.generator(seed, "traffic", "cpu"), *shape)


def test_edvr_forward_matches_the_port(tensors):
    p, _ = tensors
    x = _frames(10, 16, 20).view(2, 5, 16, 20, 3)
    with torch.no_grad():
        assert torch.allclose(_edvr(p)(x), nets.edvr(p, x, ARCH, Q), atol=2e-6)


def test_mfdn_and_resize_match_the_port(tensors):
    from dynavsr_tpu_torch.data.resize import imresize
    from dynavsr_tpu_torch.models.downscaler import MFDN
    _, pe = tensors
    x = _frames(10, 32, 44).view(2, 5, 32, 44, 3)
    assert torch.allclose(imresize(x, 0.25), nets.imresize(x, 0.25), atol=1e-6)
    est = MFDN(scale=4, nf=8, nframes=5)
    est.load_state_dict(pe, strict=True)
    with torch.no_grad():
        assert torch.allclose(est(x), nets.mfdn(pe, x, 4, Q), atol=2e-6)


def test_one_adaptation_step_matches_the_port(tensors):
    from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_fn
    from dynavsr_tpu_torch.models.padding import make_model_apply
    p, pe = tensors
    lq = _frames(8, 16, 20)
    win = ref_adapt.windows(8, 5)
    slr = nets.mfdn(pe, lq[win], 4, Q).detach()
    adapt = make_adapt_fn(AdaptConfig(n_steps=2, lr=1e-3),
                          apply_fn=make_model_apply("EDVR", 4))
    model, losses = adapt(_edvr(p), slr, lq[win][:, 2])
    ref, ref_losses, _ = ref_adapt.adapt(p, slr, lq[win][:, 2], ARCH, 2, 1e-3, Q)
    assert losses.tolist() == pytest.approx(ref_losses, rel=1e-5)
    got = model.state_dict()
    for k in p:
        assert torch.allclose(got[k] - p[k], ref[k] - p[k], atol=1e-7, rtol=1e-3), k


def test_one_meta_step_matches_the_port(tensors):
    from dynavsr_tpu_torch.models.padding import make_model_apply
    from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step
    p, pe = tensors
    hr = _frames(10, 64, 64).view(2, 5, 64, 64, 3)
    gen = torch.Generator().manual_seed(5)
    batch = ref_meta.synthesize(gen, hr, 4, pe, Q)
    net = _edvr(p)
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, betas=(0.9, 0.99), eps=1e-8)
    step = make_meta_train_step(net, MetaConfig(inner_lr=1e-2), opt, lambda c: 1e-3,
                                apply_fn=make_model_apply("EDVR", 4))
    metrics = step(batch, 0)
    ref = ref_meta.train(p, [batch], ARCH, {"lr_G": 1e-3, "beta1": 0.9, "beta2": 0.99,
                                            "maml_lr_alpha": 1e-2}, Q)
    assert float(metrics["l_outer"]) == pytest.approx(ref["outer"][0], rel=1e-5)
    got = net.state_dict()
    for k in p:
        assert torch.allclose(got[k] - p[k], ref["params"][k] - p[k], atol=1e-7, rtol=1e-3), k


def test_synthesis_matches_the_port(tensors):
    from dynavsr_tpu_torch.cli.train import synthesize_meta_batch
    _, pe = tensors
    from dynavsr_tpu_torch.models.downscaler import MFDN
    est = MFDN(scale=4, nf=8, nframes=5)
    est.load_state_dict(pe, strict=True)
    hr = _frames(10, 64, 64).view(2, 5, 64, 64, 3)
    with torch.no_grad():
        got = synthesize_meta_batch(torch.Generator().manual_seed(3), hr.numpy(), 4, est)
    ref = ref_meta.synthesize(torch.Generator().manual_seed(3), hr, 4, pe, Q)
    for k in ("LR", "SLR", "LR_center", "HR_center"):
        assert torch.allclose(got[k], ref[k], atol=2e-6), k
