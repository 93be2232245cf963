"""DUF's dynamic upsampling filter in plain PyTorch (port of
dynavsr_tpu/models/duf.py:dynamic_upsampling_filter): the plain version of
the K6/K7 kernels.

Each pixel of each channel of x is filtered by R per-pixel 5x5 filters, one
per output sub-pixel:

    out[b, c*R + r, h, w] = sum_k xpad[b, c, h + i, w + j] * f[b, k, r, h, w]

with k = 5 i + j (row-major taps, as unfold and the JAX function order
them) and xpad = x zero-padded by 2. The layout is the kernels' own, NCHW
planes: x (B, C, H, W), filters (B, 25, R, H, W), out (B, C*R, H, W) in the
channel order c*R + r that pixel_shuffle expects. Sums are taken in fp32
(filters may be bf16, as DUF's are in bf16 mode), or in float64 for a
float64 x (a reference run); the output has x's dtype.
Autograd is torch's own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["TAPS", "dynamic_upsampling_filter_ref"]

TAPS = 25  # 5 x 5


def dynamic_upsampling_filter_ref(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W), filters (B, 25, R, H, W) -> (B, C*R, H, W)."""
    b, c, h, w = x.shape
    r = filters.shape[2]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x.to(acc), (2, 2, 2, 2))
    f = filters.to(acc)
    out = None
    for k in range(TAPS):
        i, j = divmod(k, 5)
        term = xp[:, :, None, i: i + h, j: j + w] * f[:, None, k]  # (B, C, R, H, W)
        out = term if out is None else out + term
    return out.reshape(b, c * r, h, w).to(x.dtype)
