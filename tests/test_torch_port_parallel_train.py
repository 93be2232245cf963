"""The port's data-parallel training over torch.distributed (train/trainer.py,
train/meta.py, models/arch_util.py's BatchNorm, cli/train.py --launcher
pytorch) on 2 gloo CPU ranks, against the JAX package's sharded step and the
port's own one-process run.

- Supervised steps of a tiny EDVR and of TOFlow (train-mode BatchNorm: the
  global batch's statistics) at 2 ranks against JAX's make_train_step on a
  2-device mesh of the conftest's fake CPU devices, from the same weights
  (the port's init, carried to JAX through its `.pth` importer) on the same
  numpy batches, held at test_torch_port_train.py's tolerances (its
  docstring says why); both ranks' weights bitwise equal.
- A second-order meta step at 2 ranks against the port's one-process step
  on the global batch (test_torch_port_meta.py holds that one against JAX).
- `torch.distributed.run --nproc_per_node 2 -m dynavsr_tpu_torch.cli.train
  --launcher pytorch --device cpu` against the one-process CLI.
The rank functions are tests/torch_parallel_workers.py's; the two ranks of
the step checks share one spawn.
"""

import re
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers  # tests/ is on sys.path under pytest
from dynavsr_tpu.convert.torch_import import convert_state_dict
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu.parallel.mesh import data_mesh, replicate, shard_batch
from dynavsr_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from dynavsr_tpu.train.trainer import TrainState
from dynavsr_tpu.train.trainer import make_optimizer as jax_make_optimizer
from dynavsr_tpu.train.trainer import make_train_step as jax_make_train_step
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.train import schedules
from test_torch_port_parallel import _run
from test_torch_port_train import (
    TRAIN,
    _batches,
    _check_metrics,
    _check_params,
    _moved_far_more_than_they_differ,
)

STEPS = 2
META = dict(inner_lr=1e-2, inner_steps=1, first_order=False, use_remat=True)
META_LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init(arch):
    """The port's initial weights (EDVR's offset convs off zero, so the DCNs
    sample off the grid) and JAX's variables holding the same values."""
    torch.manual_seed(0)
    net = workers.net(arch)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
    # JAX's TOF in its plain conv schedule: the same function as its default
    # space-to-depth one (test_torch_port_tof.py), five times faster to compile.
    jax_model = JaxEDVR(**workers.EDVR_CFG) if arch == "EDVR" else JaxTOFlow(s2d=False)
    like = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    state = {k: v.clone() for k, v in net.state_dict().items()}
    return state, jax_model, convert_state_dict({k: v.numpy() for k, v in state.items()}, like)


def _jax_steps(jax_model, variables, batches, has_batch_stats):
    """JAX's sharded step (batch over the 2-device mesh, state replicated)."""
    mesh = data_mesh(jax.devices()[:2])
    jcfg = JaxTrainerConfig(**TRAIN)
    state = replicate(mesh, TrainState.create(apply_fn=jax_model.apply, params=variables,
                                              tx=jax_make_optimizer(jcfg)))
    jstep = jax_make_train_step(jax_model, jcfg, mesh=mesh, donate=False,
                                has_batch_stats=has_batch_stats)
    metrics = []
    for b in batches:
        state, m = jstep(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def cases():
    """EDVR: batch 2 of 3 x 16x16 LR -> 64x64 (test_torch_port_train.py's
    sizes); TOF: batch 2 of 3 x 16x16 frames, SR of the same size (its
    BatchNorms normalise over 2 x 16 x 16 samples a channel, of which each
    rank holds half). The meta batch: 2 tasks of SLR 4x4 -> LR 16x16 ->
    HR 64x64, at inner lr 1e-2: there a step without the inner gradient's
    all-reduce (each rank adapting on its own task) moves the meta gradient
    by 7e-3 of its norm, 2000 times the check's 1e-5, while at 1e-1 fp32
    rounding alone (fast weights 7e-9 apart) moves it by 1.6e-4: samples
    of the DCN cross the bilinear kinks."""
    out = {}
    for arch, gt_hw, seed in (("EDVR", 64, 1), ("TOF", 16, 2)):
        state, jax_model, variables = _init(arch)
        batches = _batches(STEPS, (2, 3, 16, 16, 3), (2, gt_hw, gt_hw, 3), seed)
        out[arch] = dict(state=state, variables=variables, batches=batches,
                         jax=_jax_steps(jax_model, variables, batches, arch == "TOF"))
    rng = np.random.default_rng(5)
    meta_batch = {"SLR": rng.random((2, 3, 4, 4, 3)), "LR": rng.random((2, 3, 16, 16, 3)),
                  "LR_center": rng.random((2, 16, 16, 3)),
                  "HR_center": rng.random((2, 64, 64, 3))}
    out["meta"] = dict(state=out["EDVR"]["state"], meta_cfg=META, lr=META_LR,
                       batch={k: v.astype(np.float32) for k, v in meta_batch.items()})
    return out


@pytest.fixture(scope="module")
def two_ranks(cases):
    train = {a: dict(arch=a, state=cases[a]["state"], train_cfg=TRAIN,
                     batches=cases[a]["batches"]) for a in ("EDVR", "TOF")}
    return workers.spawn(workers.train_and_meta, 2, train, cases["meta"])


def _model(arch, state):
    return workers.net(arch, state)


@pytest.mark.parametrize("arch", ["EDVR", "TOF"])
def test_supervised_step_on_two_ranks_matches_jax_mesh(cases, two_ranks, arch):
    """2 updates at 2 ranks (one sample a rank) against JAX's sharded step:
    each update's l_pix, grad_norm (the clip triggers on the global norm)
    and EDVR's offset metric; every parameter, the mean difference against
    how far the updates moved the weights (1 % EDVR, 5 % TOF), TOF's
    running statistics within 1e-5 plus 1 % of their change (the global
    batch's statistics: a rank's own would move them elsewhere); and the
    two ranks' weights and statistics bitwise equal."""
    c = cases[arch]
    jm, jparams = c["jax"]
    (pm0, sd0, _), (pm1, sd1, _) = two_ranks[0][0][arch], two_ranks[1][0][arch]
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    assert pm0 == pm1
    keys = ("l_pix", "grad_norm", "dcn_offset_absmean") if arch == "EDVR" else (
        "l_pix", "grad_norm")
    _check_metrics(jm, pm0, keys)
    model = _model(arch, sd0)
    lrs = [schedules.cosine_annealing_restart(
        TRAIN["lr"], TRAIN["periods"], TRAIN["restart_weights"], TRAIN["eta_min"])(i)
        for i in range(STEPS)]
    stats = _check_params(jparams, model, lrs)
    start = jax_params_to_state_dict(jax.tree.map(np.asarray, c["variables"]))
    _moved_far_more_than_they_differ(c["variables"], jparams, model, 1e-2 if arch == "EDVR"
                                     else 5e-2)
    for k, want in stats.items():  # the running statistics (TOF)
        change = float((want - start[k]).abs().max())
        assert change > 1e-4, k
        np.testing.assert_allclose(sd0[k].numpy(), want.numpy(), atol=1e-5 + 1e-2 * change,
                                   err_msg=k)
    assert bool(stats) == (arch == "TOF")


def test_meta_step_on_two_ranks_matches_one_process(cases, two_ranks):
    """One second-order meta update at 2 ranks against the port's
    one-process update on the same global batch: the gradient handed to
    Adam (the all-reduced one) within 1e-5 by relative norm, the fast
    weights identical on both ranks and within 1e-6 of the one-process
    ones, the losses within 1e-6, and both ranks' weights bitwise equal."""
    m = cases["meta"]
    one = workers.meta_step(**m)
    (met0, fast0, g0, sd0), (met1, fast1, g1, sd1) = two_ranks[0][1], two_ranks[1][1]
    assert torch.equal(fast0, fast1) and torch.equal(g0, g1) and met0 == met1
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    met, fast, grad, _ = one
    rel = float((g0 - grad).norm() / grad.norm())
    assert rel <= 1e-5, rel
    assert float((fast0 - fast).abs().max()) <= 1e-6 * float(fast.abs().max())
    for k in ("l_outer", "l_inner"):
        assert met0[k] == pytest.approx(met[k], rel=1e-6), k
    # The inner step moved the fast weights, so the inner all-reduce counts.
    start = torch.cat([t.flatten() for t in m["state"].values()
                       if t.dtype == torch.float32])
    assert float((fast - start).abs().max()) > 1e-4


# ------------------------------------------------------------------ the CLI
NITER = 2


@pytest.fixture(scope="module")
def reds(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.train.checkpoint import save_network

    root = tmp_path_factory.mktemp("parallel_train_cli")
    rng = np.random.default_rng(0)
    for clip, t in (("000", 4), ("001", 5)):
        for sub in ("GT", "LQ"):
            (root / "reds" / sub / clip).mkdir(parents=True)
        for i in range(t):
            hr = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
            cv2.imwrite(str(root / "reds" / "GT" / clip / f"{i:08d}.png"), hr)
            cv2.imwrite(str(root / "reds" / "LQ" / clip / f"{i:08d}.png"),
                        cv2.resize(hr, (16, 12), interpolation=cv2.INTER_AREA))
    save_network(str(root / "init"), 0, _model("EDVR", _init("EDVR")[0]))
    return root


def _yml(root, side):
    path = root / f"{side}.yml"
    path.write_text(textwrap.dedent(f"""
        name: cli_{side}
        model: video_base
        scale: 4
        datasets:
          train: {{name: REDS, mode: REDS, dataroot_GT: {root}/reds/GT,
                   dataroot_LQ: {root}/reds/LQ, N_frames: 3, interval_list: [1, 2],
                   random_reverse: true, LQ_size: 8, use_flip: true, use_rot: true,
                   batch_size: 2, n_workers: 1}}
        network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1,
                     back_RBs: 1}}
        path: {{root: {root}/{side}, pretrain_model_G: {root}/init/0_G.pth}}
        train: {{lr_G: 4.0e-4, niter: {NITER}, lr_scheme: constant, pixel_criterion: cb,
                 manual_seed: 0, val_freq: 1000}}
        logger: {{print_freq: 1, save_checkpoint_freq: 1000, tb_logger: false}}
        """))
    return str(path)


def _logged_l_pix(exp):
    """(log files, l_pix of each step as the log prints it, 5 digits)."""
    logs = list(exp.glob("*.log"))
    text = "".join(p.read_text() for p in logs)
    return logs, [float(v) for v in re.findall(r"l_pix: ([-\d.e+]+)", text)]


def test_training_cli_on_two_ranks_matches_one_process(reds):
    """cli.train under torchrun at 2 gloo ranks (global batch 2, one window
    a rank, flips, rotations and reversals drawn by global stream position)
    against the one-process CLI on the same config (the same batches): the
    final weights within 2 lr a step
    of each other plus 1e-5 relative and on average within 1 % of how far
    they moved (test_torch_port_train_cli.py's bounds), each step's l_pix
    as the log prints it (5 digits) alike, and rank 0 alone writing: one
    log file, a line a step, the `.pth` and `.state`."""
    from dynavsr_tpu_torch.cli import train as port_cli

    assert port_cli.main(["-opt", _yml(reds, "one"), "--device", "cpu"]) == NITER
    _run(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2", "-m",
          "dynavsr_tpu_torch.cli.train", "-opt", _yml(reds, "two"), "--launcher", "pytorch",
          "--device", "cpu"], reds)
    logged = {side: _logged_l_pix(reds / side / "experiments" / f"cli_{side}")
              for side in ("one", "two")}
    assert len(logged["two"][0]) == 1 and len(logged["two"][1]) == NITER, logged
    np.testing.assert_allclose(logged["two"][1], logged["one"][1], rtol=1e-4)
    exp = reds / "two" / "experiments" / "cli_two"
    assert (exp / "training_state" / f"{NITER}.state").exists()
    got, want = (torch.load(reds / s / "experiments" / f"cli_{s}" / "models" / f"{NITER}_G.pth",
                            weights_only=True) for s in ("two", "one"))
    start = torch.load(reds / "init" / "0_G.pth", weights_only=True)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=2 * NITER * 4e-4, err_msg=k)
    moved = np.mean(np.concatenate([(want[k] - start[k]).abs().flatten().numpy() for k in got]))
    diff = np.mean(np.concatenate([(got[k] - want[k]).abs().flatten().numpy() for k in got]))
    assert diff < 1e-2 * moved, (diff, moved)


def test_launcher_and_batch_checks(monkeypatch):
    """An unknown launcher raises, as does a world size n_devices does not
    name (models/video_base_model.check_n_devices), and init_dist on a CUDA
    device without a card (no fallback to the CPU)."""
    from dynavsr_tpu_torch.cli import train as port_cli
    from dynavsr_tpu_torch.models.video_base_model import check_n_devices
    from dynavsr_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="--launcher 'slurm'"):
        port_cli.main(["-opt", "unused.yml", "--launcher", "slurm", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for launcher in ("none", "pytorch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.init_dist(launcher)
    assert not torch.distributed.is_initialized()
    check_n_devices({"n_devices": 1})
    with pytest.raises(ValueError, match="n_devices is 2, but the launcher started 1"):
        check_n_devices({"n_devices": 2})
