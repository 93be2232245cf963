"""The port's clip-parallel adaptation and the per-rank loader
(parallel/mesh.py, adapt/adaptation.py, data/loader.py,
cli/test_dynavsr.run_clips) against the JAX package's, on CPU.

JAX runs its clip-parallel functions on a 2-device mesh of the conftest's
fake CPU devices; the port runs the same clips in one process (world size
1) and on 2 spawned gloo ranks (tests/torch_parallel_workers.py), from the
same weights (JAX inits carried over by convert/from_jax.py) and the same
numpy inputs. The multi-process checks share one spawn.
"""

import os
import random
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers  # tests/ is on sys.path under pytest
from dynavsr_tpu.adapt.adaptation import AdaptConfig as JaxAdaptConfig
from dynavsr_tpu.adapt.adaptation import batch_clips as jax_batch_clips
from dynavsr_tpu.adapt.adaptation import batch_clips_seq as jax_batch_clips_seq
from dynavsr_tpu.adapt.adaptation import make_adapt_and_infer_batched as jax_batched
from dynavsr_tpu.adapt.adaptation import make_adapt_and_infer_seq_batched as jax_seq_batched
from dynavsr_tpu.data.windows import all_windows
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.models.padding import make_mutable_model_apply as jax_mutable_apply
from dynavsr_tpu.models.tof import TOFlow as JaxTOFlow
from dynavsr_tpu.parallel.mesh import data_mesh
from dynavsr_tpu.parallel.mesh import process_local_slice as jax_process_local_slice
from dynavsr_tpu_torch.adapt import adaptation
from dynavsr_tpu_torch.data.loader import PrefetchLoader
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
from dynavsr_tpu_torch.parallel import mesh

N, H, W, S = 3, 16, 16, 4  # frames a window, LR size, scale
# Adaptation lrs: each moves the SR by ~1e-2 (checked), while Adam's first
# steps, lr * sign(grad), stay clear of the sign flips that noise-level
# gradients cause between two frameworks (test_torch_port_adapt.py).
EDVR_LR = 1e-4
TOF_LR = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs (its small ops would spin
    torch's pool against the other test workers); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ clip batching
@pytest.mark.parametrize("n_adapt", [2, 4], ids=["long-clips", "a-short-clip"])
def test_batch_clips_match_jax_exactly(n_adapt):
    """batch_clips and batch_clips_seq equal JAX's on the same numpy clips,
    bitwise, padding and lengths included; with n_adapt 4 the 2- and
    3-window clips are shorter than n_adapt and repeat their windows."""
    clips = [_rand((t, 6, 8, 3), 10 + t) for t in (4, 3, 5, 2)]
    wins = [c[all_windows(c.shape[0], N, "reflection")] for c in clips]
    for got, want in ((adaptation.batch_clips(wins, n_adapt, 1),
                       jax_batch_clips(wins, n_adapt, 1)),
                      (adaptation.batch_clips_seq(clips, N, "reflection", n_adapt, 1),
                       jax_batch_clips_seq(clips, N, "reflection", n_adapt, 1))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, list):
                assert g == w
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_batch_clips_refuse_mixed_resolutions():
    """Mixed (h, w) raises with the fix spelled out, as in JAX."""
    clips = [_rand((4, 6, 8, 3), 1), _rand((4, 8, 8, 3), 2)]
    with pytest.raises(ValueError, match="bucket clips by resolution"):
        adaptation.batch_clips([c[all_windows(4, N, "reflection")] for c in clips], 2, 1)
    with pytest.raises(ValueError, match="bucket clips by resolution"):
        adaptation.batch_clips_seq(clips, N, "reflection", 2, 1)


# ------------------------------------------------------------- the loader
class _Items:
    """Items whose value records their index and their augmentation rng."""

    def __len__(self):
        return 11

    def get_item(self, index, rng: random.Random):
        return {"x": np.array([index, rng.random()]), "key": f"k{index}"}


def _batches(rank, world, epoch, skip=0, n=3):
    loader = PrefetchLoader(_Items(), batch_size=4, seed=5, num_workers=2, rank=rank,
                            world=world)
    loader.set_epoch(epoch)
    loader.set_skip_batches(skip)
    out = [b for _, b in zip(range(n), loader)]
    return out, len(loader)


def test_loader_shares_concatenate_to_the_global_batch():
    """batch_size is the global batch: 2 ranks' batches, concatenated in
    rank order, are the one-process batch item for item (indices, keys and
    augmentation draws), in two epochs and after a resume skip; both ranks
    count the global batches; a batch size the world does not divide
    raises."""
    for epoch, skip in ((0, 0), (1, 0), (1, 1)):
        whole, n_whole = _batches(0, 1, epoch, skip, 2 - skip)
        shares = [_batches(r, 2, epoch, skip, 2 - skip) for r in range(2)]
        assert n_whole == shares[0][1] == shares[1][1] == 2
        assert len(whole) == 2 - skip
        for b, (a0, a1) in zip(whole, zip(shares[0][0], shares[1][0])):
            np.testing.assert_array_equal(np.concatenate([a0["x"], a1["x"]]), b["x"])
            assert a0["key"] + a1["key"] == b["key"] and len(a0["key"]) == 2
    with pytest.raises(ValueError, match="multiple of the world size"):
        PrefetchLoader(_Items(), batch_size=3, rank=0, world=2)


def test_process_local_slice_matches_jax():
    """The port's process_local_slice is JAX's function with the rank and
    world passed in: at rank 0 of 1 (JAX's one process) bitwise, and a
    strided share of that stream at rank r of 2."""
    want = jax_process_local_slice(23, 3, 2, ratio=2)
    np.testing.assert_array_equal(mesh.process_local_slice(23, 3, 2, 2), want)
    for r in range(2):
        np.testing.assert_array_equal(mesh.process_local_slice(23, 3, 2, 2, r, 2), want[r::2])


# ------------------------------------------- clip-parallel adapt and infer
@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() >= 2
    return data_mesh(jax.devices()[:2])


def _carried(net, jax_net, x):
    """The port's weights as JAX variables, through the JAX package's
    `.pth` importer over a jax.eval_shape template (no init compile)."""
    from dynavsr_tpu.convert.torch_import import convert_state_dict

    like = jax.eval_shape(jax_net.init, jax.random.PRNGKey(0), jnp.zeros(x))
    return convert_state_dict({k: v.numpy() for k, v in net.state_dict().items()}, like)


@pytest.fixture(scope="module")
def cases(jax_mesh):
    """Three clip-parallel cases, each run by JAX on the 2-device mesh:
    EDVR window-batched and sequence mode on 4 clips of 4, 3, 5 and 2
    windows of 16x16 (n_adapt 3: the 2-window clip repeats its windows),
    2 Adam steps at lr 1e-4, and TOF (train_ema BatchNorm adaptation, the
    bicubic x4 pre-upscale) on 2 clips of 2 windows of 8x16, JAX's
    tests/test_train.py sizes, 2 Adam steps at lr 1e-6: its BatchNorm
    statistics move by their EMA whatever the lr, while a smaller lr keeps
    Adam's sign flips on noise-level gradients (test_torch_port_tof.py)
    small. The port's initial weights (EDVR's offset convs, TOF's flow
    heads scaled up so samples fall off the grid) go to JAX."""
    torch.manual_seed(0)
    edvr = workers.net("EDVR", None)
    with torch.no_grad():
        for name, p in edvr.named_parameters():
            if "conv_offset_mask.weight" in name:
                p.normal_(0.0, 0.05)
    edvr_j = JaxEDVR(**workers.EDVR_CFG)
    ev = _carried(edvr, edvr_j, (1, N, H, W, 3))
    clips = [_rand((t, H, W, 3), 20 + t) for t in (4, 3, 5, 2)]
    n_adapt = 3
    lr_w, adapt_w, lr_c, lens = jax_batch_clips(
        [c[all_windows(c.shape[0], N, "reflection")] for c in clips], n_adapt, N // 2)
    slr = np.ascontiguousarray(adapt_w[:, :, :, ::S, ::S])  # a stand-in for MFDN's output
    frames, win, adapt_s, lr_cs, _ = jax_batch_clips_seq(clips, N, "reflection", n_adapt,
                                                         N // 2)
    slr_s = np.ascontiguousarray(adapt_s[:, :, :, ::S, ::S])
    cfg = dict(n_steps=2, lr=EDVR_LR, infer_chunk=2)
    apply_j = jax_model_apply(edvr_j, "EDVR", S)
    out = {}
    edvr_state = {k: v.clone() for k, v in edvr.state_dict().items()}
    for name, fn, stacks in (("edvr-windows", jax_batched, (slr, lr_c, lr_w)),
                             ("edvr-seq", jax_seq_batched, (slr_s, lr_cs, frames, win))):
        sr, losses = fn(edvr_j, JaxAdaptConfig(**cfg), mesh=jax_mesh, apply_fn=apply_j)(
            ev, *(jnp.asarray(s) for s in stacks))
        out[name] = dict(arch="EDVR", state=edvr_state, seq=name.endswith("seq"), cfg=cfg,
                         stacks=stacks, want=(np.asarray(sr), np.asarray(losses)), lens=lens)

    tof = workers.net("TOF", None)
    with torch.no_grad():
        for name, p in tof.named_parameters():
            if name.startswith("spynet.") and ".conv4." in name:
                p.mul_(6.0)
    tof_j = JaxTOFlow(s2d=False)
    tv = _carried(tof, tof_j, (1, N, 16, 16, 3))
    tcfg = dict(n_steps=2, lr=TOF_LR, infer_chunk=2)
    stacks = (_rand((2, 2, N, 2, 4, 3), 3), _rand((2, 2, 8, 16, 3), 4) * 0.5 + 0.25,
              _rand((2, 2, N, 8, 16, 3), 2))
    sr, losses = jax_batched(tof_j, JaxAdaptConfig(**tcfg, bn_mode="train_ema"), mesh=jax_mesh,
                             apply_fn=jax_model_apply(tof_j, "TOF", S),
                             mutable_apply_fn=jax_mutable_apply(tof_j, "TOF", S))(
        tv, *(jnp.asarray(s) for s in stacks))
    out["tof-windows"] = dict(arch="TOF", state={k: v.clone() for k, v in tof.state_dict().items()},
                              seq=False, cfg=tcfg, stacks=stacks,
                              want=(np.asarray(sr), np.asarray(losses)), lens=[2, 2])
    return out


@pytest.fixture(scope="module")
def two_ranks(cases):
    """Every case on 2 spawned gloo ranks (one spawn)."""
    payload = {k: {f: v for f, v in c.items() if f not in ("want", "lens")}
               for k, c in cases.items()}
    return workers.spawn(workers.clip_parallel, 2, payload)


# SR tolerance by architecture, as the per-clip adaptation tests' (EDVR:
# test_torch_port_adapt.py; TOF: test_torch_port_tof.py, whose docstring
# says why BatchNorm nets need more).
SR_ATOL = {"EDVR": 1e-5, "TOF": 2e-4}


def _check(case, sr, losses):
    want_sr, want_losses = case["want"]
    assert sr.shape == want_sr.shape and losses.shape == want_losses.shape
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for i, n in enumerate(case["lens"]):  # the padded rows are never scored
        np.testing.assert_allclose(sr[i, :n], want_sr[i, :n], atol=SR_ATOL[case["arch"]])


@pytest.mark.parametrize("name", ["edvr-windows", "edvr-seq", "tof-windows"])
def test_clip_parallel_matches_jax_at_world_size_1(cases, name):
    """make_adapt_and_infer[_seq]_batched in one process: every clip's SR
    and losses against JAX's 2-device-mesh run; the adaptation moved each
    clip's first SR frame by more than ten times the tolerance, so the
    check tells adapted from unadapted."""
    c = cases[name]
    net = workers.net(c["arch"], c["state"])
    build = (adaptation.make_adapt_and_infer_seq_batched if c["seq"]
             else adaptation.make_adapt_and_infer_batched)
    mutable = make_mutable_model_apply("TOF", S) if c["arch"] == "TOF" else None
    stacks = [torch.from_numpy(np.asarray(s)) for s in c["stacks"]]
    if c["seq"]:
        stacks[-1] = stacks[-1].long()
    sr, losses = build(adaptation.AdaptConfig(**c["cfg"]), make_model_apply(c["arch"], S),
                       mutable)(net, *stacks)
    _check(c, sr.numpy(), losses.numpy())
    with torch.no_grad():  # the unadapted net on each clip's first window
        first = (torch.stack([f[w] for f, w in zip(stacks[2], stacks[3][:, 0])]) if c["seq"]
                 else stacks[2][:, 0])
        unadapted = make_model_apply(c["arch"], S)(net, first).numpy()
    moved = np.abs(sr.numpy()[:, 0] - unadapted).max()
    assert moved > 10 * SR_ATOL[c["arch"]], moved


@pytest.mark.parametrize("name", ["edvr-windows", "edvr-seq", "tof-windows"])
def test_clip_parallel_matches_jax_on_two_ranks(cases, two_ranks, name):
    """The same at 2 gloo ranks, each adapting its 2 (TOF: 1) clips: both
    ranks return the whole stack, bitwise alike, and it matches JAX's."""
    (sr0, l0), (sr1, l1) = two_ranks[0][name], two_ranks[1][name]
    np.testing.assert_array_equal(sr0, sr1)
    np.testing.assert_array_equal(l0, l1)
    _check(cases[name], sr0, l0)


# ----------------------------------------------------- the real launches
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cmd, cwd, timeout=240):
    """A subprocess of this interpreter with the repo importable and one
    intra-op thread a process; returns (stdout, stderr), raising on a
    non-zero exit."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, *cmd], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout, proc.stderr


def test_dryrun_on_two_cpu_ranks(tmp_path):
    """`python -m dynavsr_tpu_torch.parallel.dryrun 2 --device cpu`: a train
    step, a meta step, clip-parallel windows and sequence mode and a tiled
    eval over 2 gloo ranks, each rank holding the same results."""
    out, _ = _run(["-m", "dynavsr_tpu_torch.parallel.dryrun", "2", "--device", "cpu"], tmp_path)
    assert "dryrun(2) OK" in out


def test_cli_clip_parallel_on_two_ranks_matches_the_serial_path(tmp_path):
    """cli.test_dynavsr with adapt.clip_parallel under torchrun at 2 gloo
    ranks (`--launcher pytorch --device cpu`) against the serial path in
    one process, on 3 clips in two resolution buckets (16x16: 5 and 4
    frames; 12x20: 4 frames, reflect mod-padded), EDVR + MFDN from the same
    `.pth` files: each clip's PSNR within 0.05 dB (JAX's
    tests/test_cli_e2e.py holds its clip-parallel CLI so), rank 0 alone
    logging the scores and writing every clip's frames."""
    cv2 = pytest.importorskip("cv2")
    from dynavsr_tpu_torch.cli.test_dynavsr import main
    from dynavsr_tpu_torch.models.downscaler import MFDN
    from dynavsr_tpu_torch.train.checkpoint import save_network

    rng = np.random.default_rng(3)
    for clip, t, (h, w) in (("a", 5, (16, 16)), ("b", 4, (16, 16)), ("c", 4, (12, 20))):
        for i in range(t):
            hr = rng.integers(0, 256, (h * S, w * S, 3), np.uint8)
            for root, img in (("GT", hr), ("LQ", cv2.resize(hr, (w, h),
                                                            interpolation=cv2.INTER_AREA))):
                (tmp_path / root / clip).mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(tmp_path / root / clip / f"{i:08d}.png"), img)
    torch.manual_seed(1)
    g = save_network(str(tmp_path / "nets"), 0, workers.net("EDVR"), "G")
    e = save_network(str(tmp_path / "nets"), 0, MFDN(scale=S, nf=8, nframes=N), "E")

    def opt(name, parallel):
        yml = tmp_path / f"{name}.yml"
        yml.write_text(textwrap.dedent(f"""
            name: {name}
            scale: 4
            datasets:
              test: {{mode: video_test, dataroot_GT: {tmp_path / 'GT'},
                      dataroot_LQ: {tmp_path / 'LQ'}, padding: reflection}}
            network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1,
                         back_RBs: 1}}
            network_E: {{which_model_G: MFDN, nf: 8}}
            adapt: {{n_steps: 2, lr: 1.0e-4, n_windows: 3, infer_chunk: 2,
                     clip_parallel: {str(parallel).lower()}}}
            path: {{root: {tmp_path}, pretrain_model_G: {g}, pretrain_model_E: {e}}}
            eval: {{ycbcr: true}}
            """))
        return str(yml)

    serial = main(["-opt", opt("serial", False), "--device", "cpu", "--no-save-images"])
    _, err = _run(["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                   "-m", "dynavsr_tpu_torch.cli.test_dynavsr", "-opt", opt("parallel", True),
                   "--launcher", "pytorch", "--device", "cpu"], tmp_path)
    psnr = {m[0]: float(m[1]) for m in re.findall(r"Clip (\w+): PSNR ([\d.]+)", err)}
    assert len(re.findall(r"Clip (\w+): PSNR", err)) == 3, err[-2000:]
    for clip in "abc":
        assert abs(psnr[clip] - serial[clip]["psnr_avg"]) <= 0.05, (clip, psnr, serial)
    saved = {p.parent.name: len(list(p.parent.glob("*.png")))
             for p in (tmp_path / "results" / "parallel").glob("*/*.png")}
    assert saved == {"a": 5, "b": 4, "c": 4}, saved
