"""Blind-protocol adaptation-gain experiment on the port (counterpart of
the repo's tools/blind_adaptation_check.py, with its flags and defaults).

A VSR net trained on bicubic LR degrades under unseen Gaussian kernels,
and MFDN-driven test-time adaptation recovers part of the loss (DynaVSR
Alg. 1). Synthetic clips, no external data:
  1. HR clips of translating multi-scale texture; LR_bic = the
     MATLAB-bicubic /4 (the training degradation), and one blurred /4 val
     leg per blind kernel in --kernels (optionally with noise);
  2. cli/train: supervised EDVR / TOF / DUF (small, bf16) on LR_bic -> HR;
  3. cli/train: MFDN (or SFDN) on random-kernel degradations;
  3b. optionally a second-order meta leg from the trained init
     (--meta-iters);
  4. cli/test: the matched bicubic PSNR; per kernel, the mismatched
     baseline, the estimator's probe (RMSE of its SLR against the true
     (LR * k) /4), and cli/test_dynavsr: k adaptation steps at each
     --adapt-lrs, the best kept;
  5. one JSON line; exit 0 iff the mean adaptation gain across kernels is
     above 0.05 dB.

The data trees are raw-byte LMDBs (data/lmdb_native.LmdbWriter: key
'<clip>_<frame:08d>', uint8 bytes, a '<key>.meta' entry 'HxWxC'), read by
the datasets' LMDB path, so no image codec or YAML parser is needed. Each
frame is stored as the JAX tool's PNG holds it (its RGB arrays written
straight through cv2.imwrite), so the port's datasets yield the arrays the
JAX tool's datasets yield. Configs are dicts derived with
config/options.derive; checkpoints are the port's `<iter>_G.pth`.

    python -m dynavsr_tpu_torch.tools.blind_adaptation_check [--sigma 1.8] [--device cpu]
    python -m dynavsr_tpu_torch.tools.blind_adaptation_check \\
        --kernels iso:1.2 iso:1.8 aniso:2.4:1.2:0.79 --meta-iters 150 --adapt-lrs 1e-6 1e-5
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import shutil
import sys
import tempfile
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynavsr_tpu_torch.cli import test as cli_test
from dynavsr_tpu_torch.cli import test_dynavsr as cli_test_dynavsr
from dynavsr_tpu_torch.cli import train as cli_train
from dynavsr_tpu_torch.config.options import derive
from dynavsr_tpu_torch.data.degradations import (
    anisotropic_kernel,
    bicubic_downsample,
    blur_downsample,
    isotropic_kernel,
)
from dynavsr_tpu_torch.data.lmdb_dataset import LmdbClipIndex
from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.train.checkpoint import load_pretrained

__all__ = ["parse_kernel", "to_u8", "put_frame", "make_gt", "make_blur_leg", "build_parser",
           "vsr_network", "run", "main"]


def parse_kernel(spec: str) -> Tuple[str, np.ndarray, float]:
    """'iso:S' or 'aniso:SX:SY:THETA', with an optional trailing 'nSIG'
    additive-Gaussian-noise part (e.g. 'iso:1.8:n0.03': noise sigma in
    [0, 1] image units, added to the LR after the blur-downsample).
    Returns (tag, kernel ndarray (13, 13), noise_sigma)."""
    parts = spec.split(":")
    noise = 0.0
    if len(parts) > 1 and parts[-1].startswith("n"):
        noise = float(parts[-1][1:])
        parts = parts[:-1]
    suffix = f"n{noise:g}" if noise else ""
    if parts[0] == "iso":
        (s,) = map(float, parts[1:])
        return f"iso{s:g}{suffix}", isotropic_kernel(13, s).numpy(), noise
    if parts[0] == "aniso":
        sx, sy, th = map(float, parts[1:])
        return (f"aniso{sx:g}x{sy:g}t{th:g}{suffix}",
                anisotropic_kernel(13, sx, sy, th).numpy(), noise)
    raise ValueError(
        f"bad kernel spec {spec!r} (iso:S | aniso:SX:SY:THETA, optional :nSIG)")


def to_u8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8, rounded as the JAX tool writes its PNGs."""
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def put_frame(writer: LmdbWriter, clip: str, i: int, frame: np.ndarray) -> None:
    """Frame i of `clip` as raw bytes under '<clip>_<i:08d>', its shape
    under '<key>.meta' (data/lmdb_dataset.py reads both)."""
    key = f"{clip}_{i:08d}".encode()
    writer.put(key, np.ascontiguousarray(frame).tobytes())
    writer.put(key + b".meta", "x".join(map(str, frame.shape)).encode())


def make_gt(root: str, seed: int, n_clips: int = 4, frames: int = 14, gh: int = 128,
            gw: int = 128, val_clips: int = 2) -> None:
    """HR clips of translating multi-scale texture (smooth fields and
    edges) and their bicubic /4 leg, as <root>/{train,val}/{GT,LQ_bic}.lmdb.
    The octaves are the JAX tool's draws; each is upsampled with
    F.interpolate's bicubic (a = -0.75, half-pixel centres, clamped
    borders: cv2.INTER_CUBIC's rule), the /4 leg is data/resize.imresize."""
    rng = np.random.default_rng(seed)
    writers = {(split, leg): LmdbWriter(f"{root}/{split}/{leg}.lmdb")
               for split in ("train", "val") for leg in ("GT", "LQ_bic")}
    try:
        for c in range(n_clips + val_clips):
            split = "train" if c < n_clips else "val"
            # 1/f-ish texture: octaves of upsampled noise (coarse dominates)
            octaves = [(rng.random((gh // f, gw // f, 3)).astype(np.float32), a)
                       for f, a in ((16, 0.5), (8, 0.25), (4, 0.15), (2, 0.10))]
            for i in range(frames):
                gt = torch.zeros(3, gh, gw)
                for o, (base, amp) in enumerate(octaves):
                    shifted = torch.from_numpy(np.roll(base, i * (o + 1), axis=1))
                    gt += amp * F.interpolate(shifted.permute(2, 0, 1)[None], size=(gh, gw),
                                              mode="bicubic", align_corners=False)[0]
                gt = gt.clamp(0, 1).permute(1, 2, 0).contiguous()
                lr_bic = imresize(gt, 0.25)
                for leg, img in (("GT", gt), ("LQ_bic", lr_bic)):
                    put_frame(writers[(split, leg)], f"{c:03d}", i, to_u8(img.numpy()))
    finally:
        for w in writers.values():
            w.close()


def make_blur_leg(root: str, tag: str, kernel: np.ndarray, noise_sigma: float = 0.0) -> None:
    """(GT * k) /4 val leg for one blind kernel, from the saved GT, as
    <root>/val/LQ_<tag>.lmdb.

    Only the val split is synthesized: supervised training reads LQ_bic,
    MFDN / meta train from GT with on-device kernels, and every test config
    points at val/LQ_<tag>. The blur runs on the frames as stored (the
    order make_gt wrote, the reader's channel swap undone), and the noise
    is the JAX tool's per-frame crc32-seeded draw."""
    gt_index = LmdbClipIndex(f"{root}/val/GT.lmdb")
    k = torch.from_numpy(np.asarray(kernel, np.float32))
    with LmdbWriter(f"{root}/val/LQ_{tag}.lmdb") as w:
        for clip in gt_index.names:
            for i, key in enumerate(gt_index.clips[clip]):
                stored = gt_index.read_frame_u8(key)[:, :, ::-1]
                gt = torch.from_numpy(stored.astype(np.float32) / 255.0)
                lr = blur_downsample(gt[None], k, 4)[0].numpy()
                if noise_sigma > 0:
                    # deterministic per-frame noise (reproducible legs); crc32,
                    # not hash(): str hashes are randomised per process.
                    name = key.decode().rpartition("_")[2]
                    nrng = np.random.default_rng(zlib.crc32(f"{tag}/{clip}/{name}.png".encode()))
                    lr = lr + nrng.normal(0.0, noise_sigma, lr.shape).astype(np.float32)
                put_frame(w, clip, i, to_u8(lr))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sigma", type=float, default=1.8,
                    help="shorthand for --kernels iso:<sigma>")
    ap.add_argument("--kernels", nargs="+", default=None,
                    help="blind kernel specs: iso:S | aniso:SX:SY:THETA")
    ap.add_argument("--seed", type=int, default=0,
                    help="data-texture + training manual_seed")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--mfdn-iters", type=int, default=600)
    ap.add_argument("--meta-iters", type=int, default=0,
                    help="optional MAML leg from the trained VSR init")
    ap.add_argument("--adapt-steps", type=int, default=20)
    ap.add_argument("--adapt-lrs", type=float, nargs="+", default=[1e-6, 1e-5, 1e-4])
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--front-rbs", type=int, default=2,
                    help="EDVR front residual blocks (EDVR-M ships 5: pass --nf 64 "
                         "--front-rbs 5 --back-rbs 10 for the production shape)")
    ap.add_argument("--back-rbs", type=int, default=3,
                    help="EDVR back residual blocks (EDVR-M ships 10)")
    ap.add_argument("--groups", type=int, default=8, help="EDVR deformable groups")
    ap.add_argument("--bn-mode", default="auto", choices=["auto", "grad_stats", "train_ema"],
                    help="BN adaptation semantics (TOF/DUF); auto = train_ema for BN nets")
    ap.add_argument("--arch", default="edvr", choices=["edvr", "tof", "duf"],
                    help="VSR backbone (the paper adapts EDVR/TOF/DUF)")
    ap.add_argument("--estimator", default="mfdn", choices=["mfdn", "sfdn"],
                    help="degradation estimator: MFDN (multi-frame, window-length-"
                         "specific) or SFDN (single-frame, window-length-agnostic)")
    ap.add_argument("--train-noise", type=float, default=0.0,
                    help="noise-aware degradation synthesis: MFDN + meta legs train with "
                         "noise_range [0, SIG]")
    ap.add_argument("--root", default=None, help="reuse an existing run dir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a host without a card raises) or cpu")
    return ap


def vsr_network(args: argparse.Namespace) -> Tuple[dict, str]:
    """The VSR net's network_G for --arch (and EDVR's shape flags), and its
    checkpoint name: the JAX tool's, with non-default shape knobs baked in
    so a reused --root never serves an nf=32 init to an nf=64 eval."""
    if args.arch == "tof":
        # raw-LR contract via the module-internal bicubic front-end
        net_g = {"which_model_G": "TOF", "pre_upscale": True, "nframes": 5,
                 "dtype": "bfloat16"}
    elif args.arch == "duf":
        # DUF's valid temporal 3D convs need the full 7-frame window
        net_g = {"which_model_G": "DUF_16L", "nframes": 7, "dtype": "bfloat16"}
    else:
        net_g = {"which_model_G": "EDVR", "nf": args.nf, "nframes": 5,
                 "groups": args.groups, "front_RBs": args.front_rbs,
                 "back_RBs": args.back_rbs, "dtype": "bfloat16"}
    vsr_name = f"vsr_{args.arch}" + (
        f"_gd{args.groups}" if args.arch == "edvr" and args.groups != 8 else "")
    if args.arch == "edvr":
        if args.nf != 32:
            vsr_name += f"_nf{args.nf}"
        if (args.front_rbs, args.back_rbs) != (2, 3):
            vsr_name += f"_rb{args.front_rbs}x{args.back_rbs}"
    return net_g, vsr_name


def _timed(seconds: dict, leg: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[leg] = time.perf_counter() - t0
    return out


def run(args: argparse.Namespace, device: Optional[torch.device] = None) -> Tuple[dict, dict]:
    """The protocol on `device` (default: resolve_device(args.device)).
    Returns (the JSON record the tool prints, details: the run dir, the
    checkpoints, the configs as derived, and each leg's seconds)."""
    device = resolve_device(args.device) if device is None else device
    kernels = [parse_kernel(s) for s in (args.kernels or [f"iso:{args.sigma:g}"])]
    root = args.root or tempfile.mkdtemp(prefix="blind_adapt_")
    data = f"{root}/data"
    seconds: dict = {}
    # A reused --root must match --seed: textures are baked into the data
    # tree (checkpoints under a different root are never mixed in).
    marker = f"{data}/.seed"
    if osp.exists(f"{data}/val/GT.lmdb"):
        old = open(marker).read().strip() if osp.exists(marker) else None
        if old != repr(args.seed):
            print(f"data tree seed is {old or 'unknown'}; regenerating for --seed {args.seed}",
                  flush=True)
            shutil.rmtree(data)
    if not osp.exists(f"{data}/val/GT.lmdb"):
        _timed(seconds, "make_gt", make_gt, data, args.seed)
        with open(marker, "w") as f:
            f.write(repr(args.seed))
    for tag, k, noise in kernels:
        if not osp.exists(f"{data}/val/LQ_{tag}.lmdb"):
            print(f"synthesizing blind-kernel leg LQ_{tag}", flush=True)
            _timed(seconds, f"make_leg_{tag}", make_blur_leg, data, tag, k, noise)
    print(f"run dir: {root}", flush=True)

    net_g, vsr_name = vsr_network(args)
    n_frames = int(net_g.get("nframes", 5))
    opts = {}

    def train_leg(leg: str, opt: dict) -> None:
        opts[leg] = derive(opt, is_train=True)
        _timed(seconds, leg, cli_train.train, opts[leg], device)

    # ---- 1) supervised VSR on bicubic LR
    vsr_ckpt = f"{root}/experiments/{vsr_name}/models/{args.iters}_G.pth"
    if not osp.exists(vsr_ckpt):
        train_leg("train_vsr", {
            "name": vsr_name, "model": "video_base", "scale": 4,
            "path": {"root": root},
            "datasets": {"train": {
                "name": "synth", "mode": "REDS",
                "dataroot_GT": f"{data}/train/GT.lmdb",
                "dataroot_LQ": f"{data}/train/LQ_bic.lmdb",
                "N_frames": n_frames, "LQ_size": 16, "batch_size": 8, "n_workers": 2,
                "use_shuffle": True}},
            "network_G": dict(net_g),
            "train": {"lr_G": 2.0e-4, "lr_scheme": "constant",
                      "niter": args.iters, "manual_seed": args.seed},
            "logger": {"print_freq": 100, "save_checkpoint_freq": args.iters,
                       "tb_logger": False},
        })
    assert osp.exists(vsr_ckpt), vsr_ckpt

    # ---- 2) MFDN on random-kernel degradations (covers the blind kernels).
    # MFDN concatenates frames along channels, so one per window length;
    # SFDN is per frame.
    est_which = args.estimator.upper()  # MFDN | SFDN
    nz = f"_nz{args.train_noise:g}" if args.train_noise > 0 else ""
    mfdn_name = f"mfdn_n{n_frames}{nz}" if est_which == "MFDN" else f"sfdn{nz}"
    mfdn_ckpt = f"{root}/experiments/{mfdn_name}/models/{args.mfdn_iters}_G.pth"
    if not osp.exists(mfdn_ckpt):
        train_ds = {
            "name": "synth_meta", "mode": "meta",
            "dataroot_GT": f"{data}/train/GT.lmdb",
            "N_frames": n_frames, "GT_size": 64, "batch_size": 8, "n_workers": 2,
            "use_shuffle": True}
        if args.train_noise > 0:
            train_ds["noise_range"] = [0.0, args.train_noise]
        train_leg("train_mfdn", {
            "name": mfdn_name, "model": "downscaler", "scale": 4,
            "path": {"root": root},
            "datasets": {"train": train_ds},
            "network_G": {"which_model_G": est_which, "nf": 64},
            "train": {"lr_G": 1.0e-4, "lr_scheme": "constant",
                      "niter": args.mfdn_iters, "manual_seed": args.seed},
            "logger": {"print_freq": 100, "save_checkpoint_freq": args.mfdn_iters,
                       "tb_logger": False},
        })
    assert osp.exists(mfdn_ckpt), mfdn_ckpt

    def test_opt(name, lq_leg):
        return {
            "name": name, "model": "video_base", "scale": 4,
            "path": {"root": root, "pretrain_model_G": vsr_ckpt},
            "datasets": {"test": {
                "name": name, "mode": "video_test",
                "dataroot_GT": f"{data}/val/GT.lmdb",
                "dataroot_LQ": f"{data}/val/{lq_leg}.lmdb",
                "N_frames": n_frames, "padding": "reflection"}},
            "network_G": dict(net_g),
            "eval": {"ycbcr": True, "crop_border": 4},
        }

    # ---- 2c) optional meta leg: MAML-train the VSR init with the estimator
    # in the loop (the paper's full recipe) before adapting. The estimator
    # is in the cache name, so a reused --root never serves an MFDN-meta
    # init to an --estimator sfdn eval.
    adapt_init_ckpt = vsr_ckpt
    if args.meta_iters > 0:
        est_sfx = "" if args.estimator == "mfdn" else f"_{args.estimator}"
        meta_name = f"meta_{vsr_name[4:]}{est_sfx}{nz}"
        meta_ckpt = f"{root}/experiments/{meta_name}/models/{args.meta_iters}_G.pth"
        if not osp.exists(meta_ckpt):
            meta_ds = {
                "name": "synth_meta", "mode": "meta",
                "dataroot_GT": f"{data}/train/GT.lmdb",
                "N_frames": n_frames, "GT_size": 64, "batch_size": 4,
                "n_workers": 2, "use_shuffle": True}
            if args.train_noise > 0:
                meta_ds["noise_range"] = [0.0, args.train_noise]
            train_leg("train_meta", {
                "name": meta_name, "model": "video_meta", "scale": 4,
                "path": {"root": root, "pretrain_model_G": vsr_ckpt,
                         "pretrain_model_E": mfdn_ckpt},
                "datasets": {"train": meta_ds},
                "network_G": dict(net_g),
                "network_E": {"which_model_G": est_which, "nf": 64},
                "train": {"lr_G": 1.0e-5, "lr_scheme": "constant",
                          "niter": args.meta_iters,
                          "maml_lr_alpha": 1.0e-5, "maml_adapt_iter": 1,
                          "manual_seed": args.seed},
                "logger": {"print_freq": 50, "save_checkpoint_freq": args.meta_iters,
                           "tb_logger": False},
            })
        adapt_init_ckpt = meta_ckpt

    # ---- 3) matched (bicubic) reference: kernel-independent
    opts["test_bic"] = derive(test_opt("bic", "LQ_bic"))
    r_bic = _timed(seconds, "test_bic", cli_test.run, opts["test_bic"], device, True)
    psnr_bic = r_bic["test"]["_avg"]["psnr_avg"]

    # ---- 4) per blind kernel: mismatched baseline + adapted sweep
    mfdn = cli_test_dynavsr.build_estimator({"which_model_G": est_which, "nf": 64}, 4,
                                            n_frames, device)
    load_pretrained(mfdn, mfdn_ckpt)

    per_kernel = {}
    for tag, k_true, _noise in kernels:
        opts[f"test_{tag}"] = derive(test_opt(tag, f"LQ_{tag}"))
        r_gauss = _timed(seconds, f"test_{tag}", cli_test.run, opts[f"test_{tag}"], device,
                         True)
        psnr_gauss = r_gauss["test"]["_avg"]["psnr_avg"]
        ssim_gauss = r_gauss["test"]["_avg"]["ssim_avg"]

        # MFDN quality probe: does MFDN(LR_blur) match the true (LR_blur * k)
        # /4 SLR? If not, the pseudo-task teaches the wrong degradation and
        # adaptation cannot help.
        t0 = time.perf_counter()
        index = LmdbClipIndex(f"{data}/val/LQ_{tag}.lmdb")
        lr_val = torch.from_numpy(np.stack([
            index.read_frame(key) for key in index.clips[index.names[0]][:n_frames]]))[None]
        lr_dev = lr_val.to(device)
        with torch.no_grad():
            slr_true = blur_downsample(lr_dev, torch.from_numpy(k_true), 4)
            slr_mfdn = mfdn(lr_dev).float()
            slr_bic = bicubic_downsample(lr_dev, 4)
        mfdn_rmse = float(torch.sqrt(torch.mean((slr_mfdn - slr_true) ** 2)))
        bic_rmse = float(torch.sqrt(torch.mean((slr_bic - slr_true) ** 2)))
        seconds[f"probe_{tag}"] = time.perf_counter() - t0
        print(f"[{tag}] MFDN probe: rmse(MFDN(LR), true SLR)={mfdn_rmse:.5f} "
              f"vs rmse(bicubic, true SLR)={bic_rmse:.5f}", flush=True)

        best = None
        sweep = {}
        for lr in args.adapt_lrs:
            adapt_opt = test_opt(f"{tag}_adapted_{lr:g}", f"LQ_{tag}")
            adapt_opt["path"]["pretrain_model_G"] = adapt_init_ckpt
            adapt_opt["path"]["pretrain_model_E"] = mfdn_ckpt
            adapt_opt["network_E"] = {"which_model_G": est_which, "nf": 64}
            adapt_opt["adapt"] = {"n_steps": args.adapt_steps, "lr": lr,
                                  "optimizer": "adam", "n_windows": 8,
                                  "bn_mode": args.bn_mode}
            leg = f"adapt_{tag}_{lr:g}"
            opts[leg] = derive(adapt_opt)
            r_adapt = _timed(seconds, leg, cli_test_dynavsr.run, opts[leg], device, True)
            p, s = r_adapt["_avg"]["psnr_avg"], r_adapt["_avg"]["ssim_avg"]
            sweep[f"{lr:g}"] = {"psnr": round(p, 4), "ssim": round(s, 4)}
            if best is None or p > best[1]:
                best = (lr, p, s)

        per_kernel[tag] = {
            "mfdn_rmse_vs_true_slr": round(mfdn_rmse, 5),
            "bicubic_rmse_vs_true_slr": round(bic_rmse, 5),
            "psnr_no_adapt": round(psnr_gauss, 4),
            "ssim_no_adapt": round(ssim_gauss, 4),
            "adapted_sweep": sweep,
            "best_adapt_lr": best[0],
            "psnr_adapted": round(best[1], 4),
            "ssim_adapted": round(best[2], 4),
            "adaptation_gain_db": round(best[1] - psnr_gauss, 4),
            "kernel_mismatch_drop_db": round(psnr_bic - psnr_gauss, 4),
        }
        print(f"[{tag}] gain {per_kernel[tag]['adaptation_gain_db']:+.2f} dB "
              f"(blind {psnr_gauss:.2f} -> adapted {best[1]:.2f})", flush=True)

    gains = [v["adaptation_gain_db"] for v in per_kernel.values()]
    record = {
        "arch": args.arch,
        "groups": args.groups if args.arch == "edvr" else None,
        "seed": args.seed,
        "bn_mode": args.bn_mode,
        "train_noise": args.train_noise,
        "estimator": args.estimator,
        "meta_iters": args.meta_iters,
        "adapt_steps": args.adapt_steps,
        "psnr_bicubic_matched": round(psnr_bic, 4),
        "ssim_bicubic_matched": round(r_bic["test"]["_avg"]["ssim_avg"], 4),
        "per_kernel": per_kernel,
        "mean_gain_db": round(float(np.mean(gains)), 4),
        "min_gain_db": round(float(np.min(gains)), 4),
        "max_gain_db": round(float(np.max(gains)), 4),
    }
    details = dict(root=root, data=data, net_g=net_g, n_frames=n_frames, vsr_ckpt=vsr_ckpt,
                   mfdn_ckpt=mfdn_ckpt, adapt_init_ckpt=adapt_init_ckpt, opts=opts,
                   seconds=seconds, mean_gain_db=float(np.mean(gains)))
    return record, details


def main(argv=None) -> int:
    """Run the protocol, print its JSON line; 0 iff the mean gain > 0.05 dB."""
    record, details = run(build_parser().parse_args(argv))
    print(json.dumps(record))
    ok = details["mean_gain_db"] > 0.05
    print(f"mean adaptation gain positive: {ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
