"""PixelShuffle with torch's channel ordering, on the port's NCHW tensors
(port of dynavsr_tpu/ops/pixelshuffle.py, which reproduces this ordering
in NHWC): out[c, h*r+dy, w*r+dx] = in[c*r*r + dy*r + dx, h, w]."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pixel_shuffle"]


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """x: (B, C*r*r, H, W) -> (B, C, H*r, W*r)."""
    if x.shape[-3] % (r * r):
        raise ValueError(f"channels {x.shape[-3]} not divisible by r^2={r * r}")
    return F.pixel_shuffle(x, r)
