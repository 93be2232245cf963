"""The port's training CLI against the JAX package's, on CPU:
`dynavsr_tpu.cli.train.main` and `dynavsr_tpu_torch.cli.train.main
--device cpu` on the same cv2-written REDS-style PNG tree and the same
YAML (a tiny EDVR: nf 8, 3 frames, Gd 2, 1 + 1 residual blocks; batch 2 of
8x8 LR crops; manual_seed 0; cosine restarts over periods of 2; 4
iterations), both starting from one `.pth` the port wrote (its offset
convs redrawn off zero), which the JAX CLI imports through its own
convert_state_dict. The two loaders draw the same batches (bitwise: see
test_torch_port_train_data.py), so each step's l_pix in the two
metrics.jsonl files must agree, and the final weights (JAX's `4_G` orbax
directory restored here and converted with jax_params_to_state_dict,
against the port's `4_G.pth`), at test_torch_port_train.py's tolerances:
l_pix 2e-4 relative; every weight within 2 x (the sum of the updates' lr)
absolute plus 1e-5 relative, and on average within a hundredth of how far
the updates moved it.
"""

import json
import textwrap

import jax
import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.train.checkpoint import save_network
from dynavsr_tpu_torch.train.schedules import cosine_annealing_restart

cv2 = pytest.importorskip("cv2")

NITER, LR, PERIODS, WEIGHTS = 4, 4e-4, (2, 2), (0.5,)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    for clip, t in (("000", 4), ("001", 6), ("002", 5)):
        for sub in ("GT", "LQ"):
            (root / "reds" / sub / clip).mkdir(parents=True)
        for i in range(t):
            base = rng.integers(0, 256, (8, 10, 3)).astype(np.float32)
            hr = cv2.resize(base, (64, 48), interpolation=cv2.INTER_CUBIC)
            hr = np.clip(hr + rng.normal(0, 4, hr.shape), 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "reds" / "GT" / clip / f"{i:08d}.png"), hr)
            cv2.imwrite(str(root / "reds" / "LQ" / clip / f"{i:08d}.png"),
                        cv2.resize(hr, (16, 12), interpolation=cv2.INTER_AREA))
    torch.manual_seed(0)
    edvr = EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
    with torch.no_grad():
        for name, p in edvr.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
    save_network(str(root / "init"), 0, edvr)
    return root


def _yml(work, side):
    body = f"""
        name: cli_{side}
        model: video_base
        scale: 4
        n_devices: 1
        datasets:
          train:
            name: REDS
            mode: REDS
            dataroot_GT: {work}/reds/GT
            dataroot_LQ: {work}/reds/LQ
            N_frames: 3
            interval_list: [1, 2]
            random_reverse: true
            LQ_size: 8
            use_flip: true
            use_rot: true
            batch_size: 2
            n_workers: 2
        network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}}
        path: {{root: {work}/{side}, pretrain_model_G: {work}/init/0_G.pth}}
        train:
          lr_G: {LR}
          beta1: 0.9
          beta2: 0.99
          niter: {NITER}
          lr_scheme: CosineAnnealingLR_Restart
          T_period: {list(PERIODS)}
          restart_weights: {list(WEIGHTS)}
          eta_min: 1.0e-7
          pixel_criterion: cb
          manual_seed: 0
          val_freq: 1000
        logger: {{print_freq: 1, save_checkpoint_freq: 1000}}
        """
    path = work / f"{side}.yml"
    path.write_text(textwrap.dedent(body))
    return str(path)


def _losses(work, side):
    with open(work / side / "tb_logger" / f"cli_{side}" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == list(range(1, NITER + 1))
    return [r["l_pix"] for r in recs]


def test_training_cli_matches_jax(work):
    from dynavsr_tpu.cli import train as jax_cli
    from dynavsr_tpu.train.checkpoint import load_network as jax_load_network
    from dynavsr_tpu_torch.cli import train as port_cli

    assert jax_cli.main(["-opt", _yml(work, "jax")]) == NITER
    assert port_cli.main(["-opt", _yml(work, "port"), "--device", "cpu"]) == NITER
    want_l, got_l = _losses(work, "jax"), _losses(work, "port")
    np.testing.assert_allclose(got_l, want_l, rtol=2e-4)
    assert got_l[0] == pytest.approx(want_l[0], rel=1e-6)  # the same start, the same batch

    jax_params = jax_load_network(str(work / "jax" / "experiments" / "cli_jax" / "models" /
                                      f"{NITER}_G"))
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, jax_params))
    got = torch.load(work / "port" / "experiments" / "cli_port" / "models" / f"{NITER}_G.pth",
                     weights_only=True)
    start = torch.load(work / "init" / "0_G.pth", weights_only=True)
    assert got.keys() == want.keys() == start.keys()
    sched = cosine_annealing_restart(LR, PERIODS, WEIGHTS, 1e-7)
    bound = 2 * sum(sched(i) for i in range(NITER))
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=bound, err_msg=k)
    moved = np.mean(np.concatenate([(got[k] - start[k]).abs().flatten().numpy() for k in got]))
    diff = np.mean(np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in got]))
    assert diff < 1e-2 * moved, (diff, moved)
    # The state file the port wrote resumes its optimizer.
    state = torch.load(work / "port" / "experiments" / "cli_port" / "training_state" /
                       f"{NITER}.state", weights_only=True)
    assert state["iter"] == NITER and len(state["optimizer"]["state"]) == len(list(
        EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1).parameters()))


def test_training_cli_refuses_the_cpu_unless_asked(work, monkeypatch):
    """Without a card, cli.train.main raises unless --device cpu is given
    (device.resolve_device), before it writes anything."""
    from dynavsr_tpu_torch.cli import train as port_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["-opt", _yml(work, "refused")])
    assert not (work / "refused").exists()
