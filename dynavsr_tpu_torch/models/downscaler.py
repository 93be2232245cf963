"""MFDN — DynaVSR's learned multi-frame downscaler (port of
dynavsr_tpu/models/downscaler.py:MFDN).

A few 3x3 conv + ReLU layers over the frame-major (T*3)-channel stack, a
stride-s conv for the downscale, two refinement convs, and a residual from
the bicubic-downscaled input, so an untrained estimator degrades to
bicubic. Boundary layout as the JAX module: (B, T, H, W, 3) in,
(B, T, H/s, W/s, 3) fp32 out.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.models.arch_util import Conv2d

__all__ = ["MFDN"]


class MFDN(nn.Module):
    def __init__(self, scale: int = 4, nf: int = 64, n_layers: int = 4, nframes: int = 5):
        super().__init__()
        self.scale = scale
        self.n_layers = n_layers
        ch = nframes * 3
        for i in range(n_layers):
            setattr(self, f"body{i}", Conv2d(ch if i == 0 else nf, nf, 3, 1, 1))
        self.down = Conv2d(nf, nf, 3, scale, 1)
        self.refine0 = Conv2d(nf, nf, 3, 1, 1)
        self.out = Conv2d(nf, ch, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        base = imresize(x, 1.0 / self.scale)  # bicubic prior
        y = x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w)  # frame-major
        for i in range(self.n_layers):
            y = F.relu(getattr(self, f"body{i}")(y))
        y = F.relu(self.down(y))
        y = F.relu(self.refine0(y))
        y = self.out(y)
        ho, wo = y.shape[-2:]
        y = y.reshape(b, t, c, ho, wo).permute(0, 1, 3, 4, 2)
        return (y + base).to(torch.float32)
