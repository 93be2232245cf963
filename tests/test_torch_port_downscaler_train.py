"""The port's downscaler training and meta-training data path against the
JAX package's, on CPU, and both new training CLIs.

JAX's degradation stream (jax.random) cannot be reproduced in torch, so
the CLIs are not compared with JAX's end to end: parity is held step by
step on fed batches (the same numpy LR / SLR through both models), and the
CLIs are held to their own contract, a resumed run bitwise the
uninterrupted one.

- DownscalerModel (create_model, model: downscaler) against JAX's
  make_train_step on MFDN (nf 8, 3 frames) and SFDN (nf 8) from the same
  weights: 3 Adam updates with an l1 loss and MultiStepLR_Restart
  (milestone 2); l_pix 1e-6 relative at the first update and 2e-4 after,
  grad_norm 2e-3, and every weight within 2 x (the sum of the updates'
  lr) plus 1e-5 relative (test_torch_port_train.py's bound).
- MetaVideoDataset items bitwise against JAX's, from image folders and
  from LMDB roots (PNG and raw entries), with its own rng and a given one;
  the `meta` modes of create_dataset.
- cli.train_downscaler and cli.train_dynavsr (MFDN in the loop) on CPU:
  4 iterations, then a run resumed from the state saved at 2, whose
  losses at 3 and 4 and final weights are bitwise the uninterrupted run's
  (each step's degradations come from a generator seeded by (seed, step)).
"""

import json
import random
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.data import datasets as jax_datasets
from dynavsr_tpu.data.lmdb_native import LmdbWriter as JaxLmdbWriter
from dynavsr_tpu.models.downscaler import MFDN as JaxMFDN
from dynavsr_tpu.models.downscaler import SFDN as JaxSFDN
from dynavsr_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dynavsr_tpu.train.trainer import TrainState
from dynavsr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dynavsr_tpu.train.trainer import make_train_step as jax_make_train_step
from dynavsr_tpu_torch.cli.train import step_generator
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.data import datasets, loader
from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter
from dynavsr_tpu_torch.models.downscaler import MFDN
from dynavsr_tpu_torch.models.video_base_model import DownscalerModel, create_model
from dynavsr_tpu_torch.train.checkpoint import save_network
from torch_one_thread import one_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

CLIPS = {"000": 5, "001": 6, "002": 3}  # 002 is shorter than a 5-frame window
LR, MILESTONE, STEPS = 1e-4, 2, 3


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """HR clips of 56x64 (smooth noise) as PNG folders, and as LMDB roots
    with PNG entries (the JAX writer) and raw BGR entries (the port's)."""
    root = tmp_path_factory.mktemp("meta_data")
    rng = np.random.default_rng(0)
    for clip, t in CLIPS.items():
        (root / "hr" / clip).mkdir(parents=True)
        for i in range(t):
            base = rng.integers(0, 256, (5, 6, 3)).astype(np.float32)
            hr = cv2.resize(base, (64, 56), interpolation=cv2.INTER_CUBIC)
            hr = np.clip(hr + rng.normal(0, 4, hr.shape), 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "hr" / clip / f"{i:08d}.png"), hr)
    for kind, writer in (("png", JaxLmdbWriter), ("raw", LmdbWriter)):
        with writer(str(root / f"hr_{kind}.lmdb")) as w:
            for clip, t in CLIPS.items():
                for i in range(t):
                    path = str(root / "hr" / clip / f"{i:08d}.png")
                    key = f"{clip}_{i:08d}".encode()
                    if kind == "raw":
                        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                        w.put(key, img.tobytes())
                        w.put(key + b".meta", "x".join(map(str, img.shape)).encode())
                    else:
                        with open(path, "rb") as f:
                            w.put(key, f.read())
    return root


def _root(data, kind):
    return str(data / "hr") if kind == "folder" else str(data / f"hr_{kind}.lmdb")


@pytest.mark.parametrize("kind", ["folder", "png", "raw"], ids=["folder", "lmdb-png", "lmdb-raw"])
@pytest.mark.parametrize("n_frames,size", [(3, 32), (5, 64)], ids=["crop", "window-past-clip"])
def test_meta_dataset_items_match_jax(data, kind, n_frames, size):
    """Every window of an epoch, cropped by the item's own rng and by a
    given one; a crop larger than the frame keeps the frame (as JAX's
    slice does)."""
    opt = {"dataroot_GT": _root(data, kind), "N_frames": n_frames, "GT_size": size, "scale": 4}
    ours, theirs = datasets.MetaVideoDataset(opt), jax_datasets.MetaVideoDataset(opt)
    assert len(ours) == len(theirs) == sum(max(1, t - n_frames + 1) for t in CLIPS.values())
    for i in range(len(ours) + 2):  # past the end wraps, as in JAX
        for rng in (None, 7):
            a = ours.get_item(i, None if rng is None else random.Random(rng + i))
            b = theirs.get_item(i, None if rng is None else random.Random(rng + i))
            assert a["key"] == b["key"]
            assert a["HR"].dtype == b["HR"].dtype == np.float32
            np.testing.assert_array_equal(a["HR"], b["HR"])


def test_create_dataset_builds_the_meta_modes(data):
    for mode in ("meta", "meta_learner", "MetaREDS", "MetaVimeo"):
        ds = loader.create_dataset({"mode": mode, "dataroot_GT": _root(data, "folder"),
                                    "N_frames": 3, "GT_size": 32})
        assert isinstance(ds, datasets.MetaVideoDataset)


def test_step_generator_is_a_function_of_seed_and_step():
    def draw(seed, step):
        return torch.rand(4, generator=step_generator(seed, step, "cpu"))

    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(1, 3), draw(0, 3))


def _downscaler_opt(which, tmp_path):
    return {"name": "down", "model": "downscaler", "scale": 4, "is_train": True,
            "datasets": {"train": {"N_frames": 3}},
            "network_G": {"which_model_G": which, "nf": 8},
            "path": {"pretrain_model_G": str(tmp_path / "0_G.pth"), "strict_load": True},
            "train": {"lr_G": LR, "lr_scheme": "MultiStepLR_Restart", "lr_steps": [MILESTONE],
                      "lr_gamma": 0.5, "beta1": 0.9, "beta2": 0.99, "pixel_criterion": "l1"}}


@pytest.mark.parametrize("which", ["MFDN", "SFDN"])
def test_downscaler_model_steps_match_jax(which, tmp_path):
    rng = np.random.default_rng(1)
    batches = [{"LR": rng.random((2, 3, 16, 16, 3)).astype(np.float32),
                "SLR": rng.random((2, 3, 4, 4, 3)).astype(np.float32)} for _ in range(STEPS)]
    jax_model = (JaxMFDN if which == "MFDN" else JaxSFDN)(scale=4, nf=8)
    variables = jax.tree.map(np.asarray, jax.jit(jax_model.init)(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]["LR"])))
    jcfg = JaxTrainerConfig(lr=LR, scheme="MultiStepLR_Restart", milestones=(MILESTONE,),
                            gamma=0.5, criterion="l1")
    state = TrainState.create(apply_fn=jax_model.apply, params=variables,
                              tx=jax_make_optimizer(jcfg))
    jstep = jax_make_train_step(jax_model, jcfg, donate=False)
    init = jax_params_to_state_dict(variables)
    torch.save(init, tmp_path / "0_G.pth")
    model = create_model(_downscaler_opt(which, tmp_path), device="cpu")
    assert isinstance(model, DownscalerModel)
    if which == "MFDN":
        assert model.netG.body0.weight.shape[1] == 9  # 3 frames x 3 channels, from N_frames
    lrs = []
    for i, b in enumerate(batches):
        state, m = jstep(state, {"LQs": jnp.asarray(b["LR"]), "GT": jnp.asarray(b["SLR"])})
        lrs.append(model.get_current_learning_rate())
        model.feed_data(b)
        model.optimize_parameters(i + 1)
        got = model.get_current_log()
        assert got["l_pix"] == pytest.approx(float(m["l_pix"]), rel=1e-6 if i == 0 else 2e-4)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=2e-3)
    assert lrs == [LR, LR, LR / 2]
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    got = model.netG.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=2 * sum(lrs),
                                   err_msg=k)


def _yml(tmp_path, data, name, model, net, extra="", resume=None, estimator=None):
    body = f"""
        name: {name}
        model: {model}
        scale: 4
        datasets:
          train:
            name: meta
            mode: meta
            dataroot_GT: {_root(data, "raw")}
            N_frames: 3
            GT_size: 48
            batch_size: 2
            n_workers: 2
        network_G: {net}
        path: {{root: {tmp_path}, resume_state: {resume or "~"},
                pretrain_model_E: {estimator or "~"}}}
        train:
          lr_G: !!float 1e-4
          lr_scheme: constant
          beta1: 0.9
          beta2: 0.99
          niter: 4
          maml_lr_alpha: !!float 1e-3
          maml_adapt_iter: 1
          first_order: false
          pixel_criterion: l1
          manual_seed: 0
          val_freq: 1000
        logger: {{print_freq: 1, save_checkpoint_freq: 2}}
        {extra}
        """
    path = tmp_path / f"{name}{'_resume' if resume else ''}.yml"
    path.write_text(textwrap.dedent(body))
    return str(path)


def _run_and_resume(tmp_path, data, cli, name, model, net, key, extra="", estimator=None):
    """4 iterations, then the same run resumed from 2.state: the losses of
    iterations 3-4 and the final weights bitwise."""
    exp = tmp_path / "experiments" / name
    assert cli.main(["-opt", _yml(tmp_path, data, name, model, net, extra, estimator=estimator),
                     "--device", "cpu"]) == 4
    first = torch.load(exp / "models" / "4_G.pth", weights_only=True)
    metrics = exp.parent.parent / "tb_logger" / name / "metrics.jsonl"
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r[key]) for r in recs)
    resume = str(exp / "training_state" / "2.state")
    assert cli.main(["-opt", _yml(tmp_path, data, name, model, net, extra, resume=resume,
                                  estimator=estimator), "--device", "cpu"]) == 4
    again = [json.loads(line) for line in metrics.read_text().splitlines()][4:]
    assert [r["step"] for r in again] == [3, 4]
    assert [r[key] for r in again] == [r[key] for r in recs[2:]]
    second = torch.load(exp / "models" / "4_G.pth", weights_only=True)
    assert first.keys() == second.keys()
    assert all(torch.equal(first[k], second[k]) for k in first)
    return recs


def test_train_downscaler_cli_resumes_bitwise(data, tmp_path):
    from dynavsr_tpu_torch.cli import train_downscaler

    _run_and_resume(tmp_path, data, train_downscaler, "mfdn", "downscaler",
                    "{which_model_G: MFDN, nf: 8}", "l_pix")


def test_train_dynavsr_cli_resumes_bitwise(data, tmp_path):
    """A tiny EDVR (nf 8, 3 frames, Gd 2, 1 + 1 blocks) meta-trained to
    second order with a frozen MFDN (nf 8) from a .pth in the loop."""
    from dynavsr_tpu_torch.cli import train_dynavsr

    torch.manual_seed(0)
    save_network(str(tmp_path / "est"), 0, MFDN(scale=4, nf=8, nframes=3))
    net = "{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}"
    recs = _run_and_resume(tmp_path, data, train_dynavsr, "meta", "video_meta", net, "l_outer",
                           extra="network_E: {which_model_G: MFDN, nf: 8}",
                           estimator=str(tmp_path / "est" / "0_G.pth"))
    assert all(r["l_inner"] > 0 and r["grad_norm"] > 0 for r in recs)
