"""The port's training data path and resume against the JAX package's, on
CPU: the LMDB reader and writer (both ways, PNG and raw entries), the REDS
and Vimeo90K training sets over folder and LMDB roots, the prefetching
loader across epochs and a skip-ahead, the training state file, and a
resumed cli/train.train run against an uninterrupted one. Frames, items
and batches must be bitwise equal (the same numpy arithmetic on the same
bytes); the resumed run's weights too (the same CPU arithmetic on the same
batches).
"""

import os
import random
import textwrap

import numpy as np
import pytest
import torch

from dynavsr_tpu.data import datasets as jax_datasets
from dynavsr_tpu.data import loader as jax_loader
from dynavsr_tpu.data.lmdb_dataset import LmdbClipIndex as JaxLmdbClipIndex
from dynavsr_tpu.data.lmdb_native import LmdbWriter as JaxLmdbWriter
from dynavsr_tpu_torch.config.options import check_resume, parse
from dynavsr_tpu_torch.data import datasets, loader, lmdb_native
from dynavsr_tpu_torch.data.lmdb_dataset import LmdbClipIndex
from dynavsr_tpu_torch.data.lmdb_native import LmdbReader, LmdbWriter
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.train.checkpoint import resume_training, save_training_state
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_train_step
from torch_one_thread import one_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

REDS = {"000": 6, "001": 7, "002": 5}  # 000 is a REDS4 clip: left out of training
VIMEO = {f"00001/000{q}": 7 for q in (1, 2, 3)}


def _write_tree(root, layout, seed, ext=".png", names=None):
    """GT frames of 32x40 (smooth noise) and LQ frames of 8x10 area-downscaled
    from them; frame names <i:08d>.png (REDS) or im<i>.png (Vimeo90K)."""
    rng = np.random.default_rng(seed)
    for clip, t in layout.items():
        for sub in ("GT", "LQ"):
            (root / sub / clip).mkdir(parents=True, exist_ok=True)
        for i in range(t):
            name = names(i) if names else f"{i:08d}{ext}"
            base = rng.integers(0, 256, (8, 10, 3)).astype(np.float32)
            hr = cv2.resize(base, (40, 32), interpolation=cv2.INTER_CUBIC)
            hr = np.clip(hr + rng.normal(0, 4, hr.shape), 0, 255).round().astype(np.uint8)
            cv2.imwrite(str(root / "GT" / clip / name), hr)
            cv2.imwrite(str(root / "LQ" / clip / name),
                        cv2.resize(hr, (10, 8), interpolation=cv2.INTER_AREA))


def _lmdb_from_tree(src, dst, writer_cls, raw):
    """One LMDB per tree: key '<clip>_<frame:08d>' (nested clips joined by
    '_'), the PNG file's bytes, or with `raw` its BGR pixels and a .meta."""
    from dynavsr_tpu.data.io import glob_clip_folders

    with writer_cls(str(dst)) as w:
        for clip, frames in glob_clip_folders(str(src)).items():
            for i, path in enumerate(frames):
                key = f"{clip}_{i:08d}".encode()
                if raw:
                    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                    w.put(key, img.tobytes())
                    w.put(key + b".meta", "x".join(map(str, img.shape)).encode())
                else:
                    with open(path, "rb") as f:
                        w.put(key, f.read())


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    _write_tree(root / "reds", REDS, seed=0)
    _write_tree(root / "vimeo", VIMEO, seed=1, names=lambda i: f"im{i + 1}.png")
    with open(root / "vimeo_list.txt", "w") as f:
        f.write("00001/0001\n00001/0003\n")
    for sub in ("GT", "LQ"):
        for kind, writer in (("png", JaxLmdbWriter), ("raw", LmdbWriter)):
            _lmdb_from_tree(root / "reds" / sub, root / f"reds_{kind}_{sub}.lmdb", writer,
                            raw=kind == "raw")
        _lmdb_from_tree(root / "vimeo" / sub, root / f"vimeo_{sub}.lmdb", LmdbWriter, raw=False)
    return root


# ------------------------------------------------------------------ LMDB
def test_the_port_builds_its_own_library():
    """The port's library is under build/native, never the JAX binding's
    native/lmdbr/liblmdbr.so."""
    so = lmdb_native.build_native()
    assert os.path.sep + os.path.join("build", "native", "liblmdbr-") in so
    assert not so.endswith(os.path.join("native", "lmdbr", "liblmdbr.so"))


@pytest.mark.parametrize("kind", ["png", "raw"])
def test_lmdb_frames_match_jax_both_ways(data, tmp_path, kind):
    """PNG entries (data_scripts/create_lmdb.py, the JAX writer) and raw
    entries with .meta: each reader reads what the other package's writer
    wrote, every frame bitwise equal to the other reader's and to
    data/io.read_img of the source file."""
    from dynavsr_tpu.data.io import glob_clip_folders, read_img

    src = data / "reds" / "GT"
    if kind == "png":
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "create_lmdb", os.path.join(os.path.dirname(__file__), "..", "data_scripts",
                                        "create_lmdb.py"))
        create_lmdb = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(create_lmdb)
        by_jax = tmp_path / "by_jax.lmdb"
        create_lmdb.main(["--input", str(src), "--output", str(by_jax)])
    else:
        by_jax = tmp_path / "by_jax.lmdb"
        _lmdb_from_tree(src, by_jax, JaxLmdbWriter, raw=True)
    by_port = tmp_path / "by_port.lmdb"
    _lmdb_from_tree(src, by_port, LmdbWriter, raw=kind == "raw")
    files = glob_clip_folders(str(src))
    for path in (by_jax, by_port):
        ours, theirs = LmdbClipIndex(str(path)), JaxLmdbClipIndex(str(path))
        assert ours.names == theirs.names == sorted(REDS)
        for clip in ours.names:
            assert ours.clips[clip] == theirs.clips[clip]
            for key, file in zip(ours.clips[clip], files[clip]):
                a, b = ours.read_frame(key), theirs.read_frame(key)
                assert a.dtype == np.float32 and a.shape == (32, 40, 3)
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, read_img(file))
    with LmdbReader(str(by_jax)) as a, LmdbReader(str(by_port)) as b:
        assert dict(a.items()) == dict(b.items()) and len(a) == len(b)


# -------------------------------------------------------------- datasets
def _reds_opt(data, root_kind, **kw):
    roots = {"folder": (data / "reds" / "GT", data / "reds" / "LQ"),
             "lmdb-png": (data / "reds_png_GT.lmdb", data / "reds_png_LQ.lmdb"),
             "lmdb-raw": (data / "reds_raw_GT.lmdb", data / "reds_raw_LQ.lmdb")}[root_kind]
    return {"mode": "REDS", "phase": "train", "scale": 4, "dataroot_GT": str(roots[0]),
            "dataroot_LQ": str(roots[1]), "N_frames": 5, "LQ_size": 4,
            "use_flip": True, "use_rot": True, **kw}


def _same_items(ours, theirs, n_draws=3):
    assert len(ours) == len(theirs)
    for index in range(len(ours)):
        for draw in range(n_draws):
            seed = hash((7, draw, index))
            a = ours.get_item(index, random.Random(seed))
            b = theirs.get_item(index, random.Random(seed))
            assert a["key"] == b["key"]
            for k in ("LQs", "GT"):
                assert a[k].dtype == np.float32 and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("root_kind", ["folder", "lmdb-png", "lmdb-raw"])
@pytest.mark.parametrize("window", ["plain", "intervals-reversed"])
def test_reds_items_match_jax(data, root_kind, window):
    """Every index, 3 rng draws each: the window (re-centred, border
    frames repeated for a dilated window longer than the clip), the
    reversal, the crop and the flips bitwise equal; REDS4's clip 000 out."""
    kw = {"interval_list": [1, 2, 3], "random_reverse": True} if window != "plain" else {}
    opt = _reds_opt(data, root_kind, **kw)
    ours, theirs = datasets.REDSDataset(opt), jax_datasets.REDSDataset(opt)
    assert ours.names == ["001", "002"] and len(ours) == 12
    _same_items(ours, theirs)


@pytest.mark.parametrize("root_kind", ["folder", "lmdb"])
@pytest.mark.parametrize("listed", [False, True], ids=["all", "meta_info_file"])
def test_vimeo90k_items_match_jax(data, root_kind, listed):
    """Nested septuplets keyed '00001_0001', 7 frames a window; with
    meta_info_file only the listed septuplets."""
    gt, lq = ((data / "vimeo" / "GT", data / "vimeo" / "LQ") if root_kind == "folder"
              else (data / "vimeo_GT.lmdb", data / "vimeo_LQ.lmdb"))
    opt = {"mode": "Vimeo90K", "phase": "train", "scale": 4, "dataroot_GT": str(gt),
           "dataroot_LQ": str(lq), "LQ_size": 4, "random_reverse": True}
    if listed:
        opt["meta_info_file"] = str(data / "vimeo_list.txt")
    ours, theirs = datasets.Vimeo90KDataset(opt), jax_datasets.Vimeo90KDataset(opt)
    want = ["00001_0001", "00001_0003"] if listed else ["00001_0001", "00001_0002", "00001_0003"]
    assert ours.names == theirs.names == want
    _same_items(ours, theirs)


def test_create_dataset_dispatches_the_training_modes(data):
    opt = _reds_opt(data, "folder")
    assert type(loader.create_dataset(opt)) is datasets.REDSDataset
    for mode in ("meta", "MetaREDS"):  # HR windows for meta / downscaler training
        assert type(loader.create_dataset({**opt, "mode": mode})) is datasets.MetaVideoDataset


# ---------------------------------------------------------------- loader
def _batches(ld, epoch, n=None):
    ld.set_epoch(epoch)
    out = []
    for b in ld:
        out.append(b)
        if n is not None and len(out) == n:
            break
    return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y) and x["key"] == y["key"]
        for k in ("LQs", "GT"):
            np.testing.assert_array_equal(x[k], y[k])


def test_prefetch_loader_matches_jax_across_epochs_and_a_skip(data):
    """create_dataloader over REDS (12 items, batch 4, 3 decode threads,
    seed 5): two epochs of batches bitwise equal to JAX's loader's, and
    again after set_skip_batches(2) in epoch 1; a consumer that stops
    early leaves no producer thread behind."""
    import threading

    opt = _reds_opt(data, "lmdb-png", interval_list=[1, 2], random_reverse=True,
                    batch_size=4, n_workers=3)
    full = {"train": {"manual_seed": 5}}
    ours = loader.create_dataloader(datasets.REDSDataset(opt), opt, full)
    theirs = jax_loader.create_dataloader(jax_datasets.REDSDataset(opt), opt, full)
    assert len(ours) == len(theirs) == 3
    for epoch in (0, 1):
        _same_batches(_batches(ours, epoch), _batches(theirs, epoch))
    ours.set_skip_batches(2)
    theirs.set_skip_batches(2)
    skipped = _batches(ours, 1)
    _same_batches(skipped, _batches(theirs, 1))
    _same_batches(skipped, _batches(ours, 1)[2:])
    before = threading.active_count()
    _batches(ours, 0, n=1)
    assert threading.active_count() == before


def test_prefetch_loader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def get_item(self, index, rng):
            raise OSError(f"unreadable frame {index}")

    with pytest.raises(OSError, match="unreadable frame"):
        next(iter(loader.PrefetchLoader(Broken(), batch_size=2)))


# ------------------------------------------------------ checkpoints, resume
def test_training_state_round_trips_the_optimizer(tmp_path):
    """<it>.state holds epoch, iter and the optimizer: Adam's moments and
    step, bitwise, into a fresh optimizer over another copy of the net."""
    torch.manual_seed(0)
    net = EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)
    cfg = TrainerConfig(lr=1e-3, scheme="constant")
    opt = make_optimizer(cfg, net.parameters())
    step = make_train_step(net, cfg, opt)
    rng = np.random.default_rng(0)
    for i in range(2):
        step({"LQs": torch.from_numpy(rng.random((1, 3, 8, 8, 3), np.float32)),
              "GT": torch.from_numpy(rng.random((1, 32, 32, 3), np.float32))}, i)
    path = save_training_state(str(tmp_path), 3, 2, opt)
    assert path.endswith(os.path.join(str(tmp_path), "2.state"))
    fresh = make_optimizer(cfg, EDVR(nf=8, nframes=3, groups=2, front_RBs=1,
                                     back_RBs=1).parameters())
    assert resume_training(path, fresh) == (3, 2)
    a, b = opt.state_dict(), fresh.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for k, s in a["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], b["state"][k][name]), (k, name)


def _train_yml(tmp_path, data, name, niter, save_freq=100, resume=None):
    body = f"""
        name: {name}
        model: video_base
        scale: 4
        datasets:
          train:
            name: REDS
            mode: REDS
            dataroot_GT: {data}/reds/GT
            dataroot_LQ: {data}/reds/LQ
            N_frames: 3
            interval_list: [1, 2]
            random_reverse: true
            LQ_size: 4
            batch_size: 6
            n_workers: 2
        network_G: {{which_model_G: EDVR, nf: 8, nframes: 3, groups: 2, front_RBs: 1, back_RBs: 1}}
        path: {{root: {tmp_path}{", resume_state: " + resume if resume else ""}}}
        train:
          lr_G: 4.0e-4
          niter: {niter}
          T_period: [3, 3]
          restart_weights: [0.5]
          weight_decay_G: 0.01
          manual_seed: 3
        logger: {{print_freq: 1, save_checkpoint_freq: {save_freq}, tb_logger: false}}
        """
    path = tmp_path / f"{name}_{niter}.yml"
    path.write_text(textwrap.dedent(body))
    return parse(str(path), is_train=True)


def _load(path):
    return torch.load(path, weights_only=True)


@pytest.mark.parametrize("save", ["in-loop-3", "in-loop-4", "final-3"])
def test_resumed_training_is_bitwise_the_uninterrupted_run(data, tmp_path, save):
    """cli/train.train on the CPU (2 batches an epoch): 6 uninterrupted
    iterations, against a resume up to 6 from a training state saved
    in the loop at iteration 3 or 4, or by the final save of a 3-iteration
    run (which records the epoch as the run's epoch count). The final
    6_G.pth and the optimizer's state are bitwise equal. The next batch is
    batch (iter mod 2) of epoch (iter div 2) in each case; skipping iter
    mod 2 batches of the saved epoch, as the JAX CLI does, would replay
    epoch 1 after the save at 4 and start in epoch 2 after the final save
    at 3."""
    from dynavsr_tpu_torch.cli.train import train

    stop = int(save[-1])
    whole = _train_yml(tmp_path, data, "whole", 6, save_freq=stop)
    assert train(whole, device="cpu") == 6
    want = _load(os.path.join(whole["path"]["models"], "6_G.pth"))
    want_state = _load(os.path.join(whole["path"]["training_state"], "6.state"))
    name = "whole"
    if save.startswith("final"):
        name = "split"
        assert train(_train_yml(tmp_path, data, name, stop), device="cpu") == stop
    state = os.path.join(tmp_path, "experiments", name, "training_state", f"{stop}.state")
    assert _load(state)["epoch"] == (1 if save.startswith("in-loop") else 2)
    resumed = _train_yml(tmp_path, data, name, 6, resume=state)
    check_resume(resumed, stop)
    assert resumed["path"]["pretrain_model_G"].endswith(os.path.join("models", f"{stop}_G.pth"))
    assert train(resumed, device="cpu") == 6
    got = _load(os.path.join(resumed["path"]["models"], "6_G.pth"))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    got_state = _load(os.path.join(resumed["path"]["training_state"], "6.state"))
    assert got_state["iter"] == want_state["iter"] == 6
    for k, s in want_state["optimizer"]["state"].items():
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], got_state["optimizer"]["state"][k][name]), (k, name)
