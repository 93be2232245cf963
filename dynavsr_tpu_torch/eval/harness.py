"""Clip scoring — copy of dynavsr_tpu/eval/harness.py:score_frames.

uint8 rounding, optional Y-channel conversion and border cropping
reproduce the reference's PSNR/SSIM definitions (eval/metrics.py).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from dynavsr_tpu_torch.data.color import rgb2ycbcr
from dynavsr_tpu_torch.eval.convert_img import save_img, tensor2img
from dynavsr_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim

__all__ = ["score_frames"]


def _metric_img(img_u8: np.ndarray, ycbcr: bool, crop: int) -> np.ndarray:
    out = img_u8.astype(np.float64)
    if ycbcr:
        out = rgb2ycbcr(out / 255.0, only_y=True) * 255.0
    if crop:
        out = out[crop:-crop, crop:-crop]
    return out


def score_frames(
    sr: np.ndarray,
    gt_frames: Optional[np.ndarray],
    ycbcr: bool = False,
    crop_border: int = 0,
    save_dir: Optional[str] = None,
) -> dict:
    """Score (and optionally save) SR frames (T, H, W, 3) in [0, 1] against GT."""
    t = sr.shape[0]
    res = dict(psnr=[], ssim=[], frames=t)
    for i in range(t):
        sr_u8 = tensor2img(sr[i])
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            save_img(sr_u8, osp.join(save_dir, f"{i:08d}.png"))
        if gt_frames is not None:
            gt_u8 = tensor2img(gt_frames[i])
            a = _metric_img(sr_u8, ycbcr, crop_border)
            b = _metric_img(gt_u8, ycbcr, crop_border)
            res["psnr"].append(calculate_psnr(a, b))
            res["ssim"].append(calculate_ssim(a, b))
    if gt_frames is not None:
        res["psnr_avg"] = float(np.mean(res["psnr"]))
        res["ssim_avg"] = float(np.mean(res["ssim"]))
    return res
