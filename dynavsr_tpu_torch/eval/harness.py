"""Clip and dataset evaluation — copy of dynavsr_tpu/eval/harness.py.

Every frame's window is stacked (data/windows.all_windows) and the clip runs
in chunks of windows through `infer_fn`, or once through a sequence-mode
`seq_fn`; then uint8 rounding, optional Y-channel conversion and border
cropping reproduce the reference's PSNR/SSIM definitions (eval/metrics.py).
The Vimeo90K-T protocol (a test set with `center_only`) batches one window
per septuplet. A clip without GT is super-resolved but not scored, and the
average covers the scored clips only.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Dict, Optional

import numpy as np

from dynavsr_tpu_torch.data.color import rgb2ycbcr
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.eval.convert_img import save_img, tensor2img
from dynavsr_tpu_torch.eval.metrics import calculate_psnr, calculate_ssim

__all__ = ["ClipResult", "evaluate_clip", "evaluate_dataset", "score_frames"]


class ClipResult(dict):
    """One clip's scores: psnr / ssim per frame, frames, and psnr_avg /
    ssim_avg when it had GT."""


def _metric_img(img_u8: np.ndarray, ycbcr: bool, crop: int) -> np.ndarray:
    out = img_u8.astype(np.float64)
    if ycbcr:
        out = rgb2ycbcr(out / 255.0, only_y=True) * 255.0
    if crop:
        out = out[crop:-crop, crop:-crop]
    return out


def _chunked(infer_fn: Callable, windows: np.ndarray, chunk: int) -> np.ndarray:
    return np.concatenate([np.asarray(infer_fn(windows[s: s + chunk]))
                           for s in range(0, windows.shape[0], chunk)], axis=0)


def evaluate_clip(
    infer_fn: Callable[[np.ndarray], np.ndarray],
    lq_frames: np.ndarray,
    gt_frames: Optional[np.ndarray],
    n_frames: int = 5,
    padding: str = "reflection",
    chunk: int = 8,
    ycbcr: bool = False,
    crop_border: int = 0,
    save_dir: Optional[str] = None,
    seq_fn: Optional[Callable] = None,
) -> ClipResult:
    """SR over one clip and its scores. infer_fn: (F, N, h, w, 3) windows
    -> (F, H, W, 3), called on `chunk` windows at a time; seq_fn, when
    given, replaces it: (frames (T, h, w, 3), win (T, N)) -> (T, H, W, 3)."""
    win = all_windows(lq_frames.shape[0], n_frames, padding)
    if seq_fn is not None:
        sr = np.asarray(seq_fn(lq_frames, win))
    else:
        sr = _chunked(infer_fn, lq_frames[win], chunk)
    return score_frames(sr, gt_frames, ycbcr, crop_border, save_dir)


def score_frames(
    sr: np.ndarray,
    gt_frames: Optional[np.ndarray],
    ycbcr: bool = False,
    crop_border: int = 0,
    save_dir: Optional[str] = None,
) -> ClipResult:
    """Score (and optionally save) SR frames (T, H, W, 3) in [0, 1] against GT."""
    t = sr.shape[0]
    res = ClipResult(psnr=[], ssim=[], frames=t)
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


def _average(results: Dict[str, ClipResult], logger) -> None:
    scored = [r for r in results.values() if "psnr_avg" in r]
    if not scored:
        return
    results["_avg"] = ClipResult(psnr_avg=float(np.mean([r["psnr_avg"] for r in scored])),
                                 ssim_avg=float(np.mean([r["ssim_avg"] for r in scored])))
    if logger:
        logger.info("Average: PSNR %.4f dB SSIM %.4f",
                    results["_avg"]["psnr_avg"], results["_avg"]["ssim_avg"])


def evaluate_dataset(
    infer_fn: Callable[[np.ndarray], np.ndarray],
    test_set,
    n_frames: int = 5,
    padding: str = "reflection",
    chunk: int = 8,
    ycbcr: bool = False,
    crop_border: int = 0,
    save_root: Optional[str] = None,
    logger=None,
    seq_fn: Optional[Callable] = None,
) -> Dict[str, ClipResult]:
    """{clip: ClipResult} over a test set (data/datasets.py), plus '_avg'
    over the scored clips. On the centre-only protocol every item's window
    is batched, `chunk` at a time, and seq_fn is not used (one window a
    septuplet shares nothing)."""
    results: Dict[str, ClipResult] = {}
    if getattr(test_set, "center_only", False):
        items = [test_set[i] for i in range(len(test_set))]
        sr = _chunked(infer_fn, np.stack([it["LQs"] for it in items]), chunk)
        for it, sr_i in zip(items, sr):
            gt_i = it.get("GT")
            res = score_frames(sr_i[None], None if gt_i is None else gt_i[None], ycbcr,
                               crop_border,
                               save_dir=osp.join(save_root, it["folder"]) if save_root else None)
            results[it["folder"]] = res
            if logger and "psnr_avg" in res:
                logger.info("Seq %s: PSNR %.4f SSIM %.4f", it["folder"], res["psnr_avg"],
                            res["ssim_avg"])
        _average(results, logger)
        return results
    for clip in test_set.names:
        lq = test_set.clip_frames(clip)
        gt = test_set.clip_frames(clip, gt=True) if test_set.has_gt(clip) else None
        res = evaluate_clip(infer_fn, lq, gt, n_frames, padding, chunk, ycbcr, crop_border,
                            save_dir=osp.join(save_root, clip) if save_root else None,
                            seq_fn=seq_fn)
        results[clip] = res
        if logger and "psnr_avg" in res:
            logger.info("Clip %s: PSNR %.4f dB SSIM %.4f (%d frames)", clip, res["psnr_avg"],
                        res["ssim_avg"], res["frames"])
    _average(results, logger)
    return results
