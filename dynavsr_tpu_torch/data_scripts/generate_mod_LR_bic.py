"""Generate mod-cropped GT and MATLAB-bicubic (or DUF) LR frames (port of
the repo's data_scripts/generate_mod_LR_bic.py).

    python -m dynavsr_tpu_torch.data_scripts.generate_mod_LR_bic --input <GT tree> \
        --output <out root> --scale 4 [--mode duf] [--device cpu]

Writes <out>/GT (mod-cropped) and <out>/LRx<scale>: data/resize.imresize
(MATLAB's bicubic with antialiasing, fp32) or, with --mode duf,
data/degradations.duf_downsample (13-tap Gaussian blur, stride subsample),
on --device (the card unless the caller asks for the CPU). Frames are read
and written with OpenCV, imported when the script runs.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from dynavsr_tpu_torch.data.degradations import duf_downsample
from dynavsr_tpu_torch.data.io import glob_clip_folders
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.utils.util import ProgressBar

__all__ = ["downscale", "main"]


def downscale(img: np.ndarray, scale: int, mode: str, device: torch.device) -> np.ndarray:
    """(H, W) or (H, W, C) float32 frame in [0, 1] -> its LR on `device`,
    back on the host."""
    x = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    x = x[..., None] if x.ndim == 2 else x
    with torch.no_grad():
        lr = duf_downsample(x[None], scale)[0] if mode == "duf" else imresize(x, 1.0 / scale)
    lr = lr.cpu().numpy()
    return lr[..., 0] if img.ndim == 2 else lr


def main(argv=None) -> None:
    import cv2

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--scale", type=int, default=4)
    ap.add_argument("--mode", choices=["bicubic", "duf"], default="bicubic",
                    help="'duf': 13-tap Gaussian blur + stride subsample "
                         "(data/degradations.duf_downsample) for DUF eval")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a host without a card raises) or cpu")
    args = ap.parse_args(argv)

    s, device = args.scale, resolve_device(args.device)
    clips = glob_clip_folders(args.input)
    bar = ProgressBar(sum(len(v) for v in clips.values()))
    for clip, frames in clips.items():
        gt_dir = osp.join(args.output, "GT", clip)
        lr_dir = osp.join(args.output, f"LRx{s}", clip)
        os.makedirs(gt_dir, exist_ok=True)
        os.makedirs(lr_dir, exist_ok=True)
        for path in frames:
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 255.0
            h, w = img.shape[:2]
            img = img[: h - h % s, : w - w % s]  # mod-crop
            lr = downscale(img, s, args.mode, device)
            name = osp.basename(path)
            for d, frame in ((gt_dir, img), (lr_dir, lr)):
                cv2.imwrite(osp.join(d, name),
                            (np.clip(frame, 0, 1) * 255.0).round().astype(np.uint8))
            bar.update(f"{clip}/{name}")
    print("\ndone.")


if __name__ == "__main__":
    main()
