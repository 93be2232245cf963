"""DUF's blur-matched downsample (port of dynavsr_tpu/data/degradations.py:
`_duf_kernel_np`, `duf_downsample`; the rest of that module, the random
blur kernels and pair synthesis for training, is not ported yet).

DUF expects LR frames made this way (configs/test/test_DUF_Vid4.yml): a
fixed 13x13 Gaussian of sigma 0.4 * scale, reflect padding, stride `scale`,
and a 2-pixel crop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["duf_downsample"]


@functools.lru_cache(maxsize=8)
def _duf_kernel_np(scale: int) -> np.ndarray:
    """13x13 DUF Gaussian: impulse response of a sigma=0.4*scale separable
    Gaussian truncated at radius int(4*sigma+0.5), embedded in 13 taps (the
    reference's scipy.gaussian_filter construction)."""
    sigma = 0.4 * scale
    radius = int(4.0 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (xs / sigma) ** 2)
    g /= g.sum()
    full = np.zeros(13, dtype=np.float64)
    c = 6
    lo, hi = max(0, c - radius), min(13, c + radius + 1)
    src_lo = lo - (c - radius)
    full[lo:hi] = g[src_lo: src_lo + (hi - lo)]
    return np.outer(full, full)


def duf_downsample(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """x (..., H, W, C) -> (..., H', W', C): reflect-pad by 6 + 2*scale
    (plus the remainder to a multiple of 3 for scale 3), 13x13 Gaussian
    depthwise conv with stride `scale`, then crop 2 pixels a side."""
    if scale not in (2, 3, 4):
        raise ValueError(f"scale {scale} not supported")
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    xf = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    pad = 6 + scale * 2
    r_h = (-h) % scale if scale == 3 else 0
    r_w = (-w) % scale if scale == 3 else 0
    xp = F.pad(xf, (pad, pad + r_w, pad, pad + r_h), mode="reflect")
    k = torch.as_tensor(_duf_kernel_np(scale), dtype=xf.dtype, device=xf.device)
    out = F.conv2d(xp, k.expand(c, 1, 13, 13), stride=scale, groups=c)
    out = out[:, :, 2:-2, 2:-2].permute(0, 2, 3, 1)
    return out.reshape(*lead, *out.shape[1:])
