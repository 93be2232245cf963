"""Training-convergence proof on the port (counterpart of the repo's
tools/convergence_check.py, with its flags and defaults): train a small
EDVR on synthetic data and check that (a) the loss descends and (b) val
PSNR beats bicubic upsampling.

It runs the real stack: datasets -> loader -> train step -> eval harness.
The data are the JAX tool's: 6 clips of 12 frames of 96x96 GT, each frame
a 12x12 noise field rolled 1 px a frame and upsampled x8 (F.interpolate's
bicubic: cv2.INTER_CUBIC's rule), its LQ a 4x4 box mean (cv2.INTER_AREA at
an integer factor). Frames are stored as the JAX tool's PNGs hold them
(its RGB arrays written straight through cv2.imwrite) in raw-byte LMDBs
(data/lmdb_native.LmdbWriter), read by the datasets' LMDB path, so no
image codec is needed. The model is EDVR nf 32, 2 + 3 blocks, Gd 8, bf16,
trained at batch 8 on 16x16 LQ crops, lr 2e-4 constant. The pass rule:
the last logged loss below 0.7x the first, and the trained val PSNR above
the bicubic upsampling's (data/resize.imresize of each window's centre).

    python -m dynavsr_tpu_torch.tools.convergence_check [--iters 300] [--nf 32] [--device cpu]

Prints one JSON line at the end; exits 0 iff both rules hold.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter
from dynavsr_tpu_torch.data.loader import create_dataloader, create_dataset
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import evaluate_dataset
from dynavsr_tpu_torch.models.video_base_model import VideoBaseModel
from dynavsr_tpu_torch.tools.blind_adaptation_check import put_frame, to_u8
from dynavsr_tpu_torch.utils.util import set_random_seed

__all__ = ["make_data", "make_opt", "bicubic_psnr", "passes", "build_parser", "run", "main"]

LOSS_DROP = 0.7  # the last logged l_pix must fall below this share of the first
LOG_EVERY = 50  # l_pix is logged at update 1 and every LOG_EVERY updates


def make_data(root: str, n_clips: int = 6, frames: int = 12, gh: int = 96,
              gw: int = 96) -> Tuple[str, str]:
    """The JAX tool's clips as <root>/GT.lmdb and <root>/LQ.lmdb; returns
    both paths."""
    rng = np.random.default_rng(0)
    gt_path, lq_path = f"{root}/GT.lmdb", f"{root}/LQ.lmdb"
    with LmdbWriter(gt_path) as gt_w, LmdbWriter(lq_path) as lq_w:
        for c in range(n_clips):
            base = rng.random((gh // 8, gw // 8, 3)).astype(np.float32)
            for i in range(frames):
                shifted = torch.from_numpy(np.roll(base, i, axis=1)).permute(2, 0, 1)[None]
                gt = F.interpolate(shifted, size=(gh, gw), mode="bicubic",
                                   align_corners=False).clamp(0, 1)
                lr = F.avg_pool2d(gt, 4)
                put_frame(gt_w, f"{c:03d}", i, to_u8(gt[0].permute(1, 2, 0).numpy()))
                put_frame(lq_w, f"{c:03d}", i, to_u8(lr[0].permute(1, 2, 0).numpy()))
    return gt_path, lq_path


def make_opt(gt: str, lq: str, nf: int = 32) -> dict:
    """The JAX tool's config, on the LMDB trees."""
    return {
        "is_train": True, "scale": 4, "n_devices": 1, "model": "video_base",
        "datasets": {
            "train": {
                "phase": "train", "mode": "REDS", "scale": 4,
                "dataroot_GT": gt, "dataroot_LQ": lq,
                "N_frames": 5, "LQ_size": 16, "batch_size": 8, "n_workers": 2,
            },
            "val": {
                "phase": "val", "mode": "video_test", "scale": 4,
                "dataroot_GT": gt, "dataroot_LQ": lq,
                "N_frames": 5, "padding": "reflection",
            },
        },
        "network_G": {
            "which_model_G": "EDVR", "nf": nf, "nframes": 5, "groups": 8,
            "front_RBs": 2, "back_RBs": 3, "dtype": "bf16",
        },
        "path": {},
        "train": {"lr_G": 2e-4, "lr_scheme": "constant", "manual_seed": 0},
    }


def bicubic_psnr(val_set, device: torch.device) -> float:
    """The val set's mean PSNR of the MATLAB-bicubic x4 upsampling of each
    window's centre frame (the JAX tool's `bicubic_infer`)."""
    def bicubic_infer(w: np.ndarray) -> np.ndarray:
        c = torch.as_tensor(w[:, w.shape[1] // 2], device=device)
        return imresize(c, 4.0).cpu().numpy()

    return evaluate_dataset(bicubic_infer, val_set, n_frames=5)["_avg"]["psnr_avg"]


def passes(losses: Sequence[float], psnr: float, bic: float) -> Tuple[bool, bool]:
    """(the loss descended: last < LOSS_DROP x first, val PSNR beats bicubic)."""
    return bool(losses[-1] < losses[0] * LOSS_DROP), bool(psnr > bic)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--nf", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a host without a card raises) or cpu")
    return ap


def run(args: argparse.Namespace, device: Optional[torch.device] = None,
        root: Optional[str] = None, data: Optional[dict] = None) -> Tuple[dict, dict]:
    """Write the data into `root` (default: a new temp dir), score bicubic,
    train args.iters updates, score the trained net. `data` overrides
    make_data's sizes. Returns (the JSON record, details: the model, the
    last batch, the val set, the config)."""
    device = resolve_device(args.device) if device is None else device
    root = root or tempfile.mkdtemp(prefix="conv_check_")
    gt, lq = make_data(root, **(data or {}))
    opt = make_opt(gt, lq, args.nf)
    set_random_seed(opt["train"]["manual_seed"])
    model = VideoBaseModel(opt, device)
    train_set = create_dataset(opt["datasets"]["train"])
    loader = create_dataloader(train_set, opt["datasets"]["train"], opt)
    val_set = create_dataset(opt["datasets"]["val"])
    if len(loader) == 0:
        raise ValueError(f"{len(train_set)} training items make no batch of "
                         f"{opt['datasets']['train']['batch_size']}")

    bic = bicubic_psnr(val_set, device)
    print(f"bicubic val PSNR: {bic:.3f} dB", flush=True)

    losses, logged = [], []
    step, batch = 0, None
    t0 = time.perf_counter()
    while step < args.iters:
        loader.set_epoch(step)
        for batch in loader:
            if step >= args.iters:
                break
            model.feed_data(batch)
            model.optimize_parameters(step)  # its log holds host floats: synchronised
            step += 1
            if step % LOG_EVERY == 0 or step == 1:
                losses.append(model.get_current_log()["l_pix"])
                logged.append(step)
                print(f"iter {step}: l_pix {losses[-1]:.5f} "
                      f"({(time.perf_counter() - t0) / step * 1000:.0f} ms/it avg)", flush=True)
    train_s = time.perf_counter() - t0

    psnr = evaluate_dataset(model.make_infer_fn(), val_set, n_frames=5)["_avg"]["psnr_avg"]
    print(f"trained val PSNR: {psnr:.3f} dB (bicubic {bic:.3f})", flush=True)
    ok_loss, ok_psnr = passes(losses, psnr, bic)
    print(f"loss descended: {ok_loss} ({losses[0]:.4f} -> {losses[-1]:.4f}); "
          f"beats bicubic: {ok_psnr}", flush=True)
    record = {"iters": args.iters, "nf": args.nf, "device": str(device),
              "psnr_bicubic": round(bic, 4), "psnr_trained": round(psnr, 4),
              "l_pix": [[s, round(v, 6)] for s, v in zip(logged, losses)],
              "ms_per_update": round(train_s / max(step, 1) * 1e3, 3),
              "loss_descended": ok_loss, "beats_bicubic": ok_psnr, "pass": ok_loss and ok_psnr}
    details = dict(root=root, model=model, batch=batch, val_set=val_set, opt=opt,
                   train_s=train_s)
    return record, details


def main(argv=None) -> int:
    """Run the check, print its JSON line; 0 iff both pass rules hold."""
    record, _ = run(build_parser().parse_args(argv))
    print(json.dumps(record))
    return 0 if record["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
