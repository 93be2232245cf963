"""MFDN / SFDN — DynaVSR's learned downscalers (port of
dynavsr_tpu/models/downscaler.py).

A few 3x3 conv + ReLU layers, a stride-s conv for the downscale, a
refinement conv, an output conv, and a residual from the bicubic-downscaled
input, so an untrained estimator degrades to bicubic. MFDN runs over the
frame-major (T*3)-channel stack of a window; SFDN runs the same layers on
each frame alone. With `dtype=torch.bfloat16` the convs run in bf16 (the
parameters stay fp32); the output is fp32 either way. Boundary layout as
the JAX modules: (B, T, H, W, 3) in, (B, T, H/s, W/s, 3) out; SFDN also
takes single frames (B, H, W, 3).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.models.arch_util import Conv2d, variance_scaling_

__all__ = ["MFDN", "SFDN"]


class _Downscaler(nn.Module):
    """The layers MFDN and SFDN share, over `ch` input (and output) channels."""

    def __init__(self, ch: int, scale: int, nf: int, n_layers: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.scale = scale
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"body{i}", Conv2d(ch if i == 0 else nf, nf, 3, 1, 1,
                                             compute_dtype=dtype))
        self.down = Conv2d(nf, nf, 3, scale, 1, compute_dtype=dtype)
        self.refine0 = Conv2d(nf, nf, 3, 1, 1, compute_dtype=dtype)
        self.out = Conv2d(nf, ch, 3, 1, 1, compute_dtype=dtype)
        for m in self.modules():
            if isinstance(m, Conv2d):
                variance_scaling_(m.weight, 1.0)
                nn.init.zeros_(m.bias)

    def _layers(self, y: torch.Tensor) -> torch.Tensor:
        """(B, ch, H, W) -> (B, ch, H/s, W/s), without the bicubic residual."""
        for i in range(self.n_layers):
            y = F.relu(getattr(self, f"body{i}")(y))
        y = F.relu(self.down(y))
        y = F.relu(self.refine0(y))
        return self.out(y)


class MFDN(_Downscaler):
    """Multi-frame: (B, T, H, W, 3) -> (B, T, H/s, W/s, 3) fp32."""

    def __init__(self, scale: int = 4, nf: int = 64, n_layers: int = 4, nframes: int = 5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(nframes * 3, scale, nf, n_layers, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        base = imresize(x, 1.0 / self.scale)  # bicubic prior
        y = self._layers(x.permute(0, 1, 4, 2, 3).reshape(b, t * c, h, w))  # frame-major
        ho, wo = y.shape[-2:]
        y = y.reshape(b, t, c, ho, wo).permute(0, 1, 3, 4, 2)
        return (y + base).to(torch.float32)


class SFDN(_Downscaler):
    """Single-frame: (B, H, W, 3) -> (B, H/s, W/s, 3) fp32, or
    (B, T, H, W, 3) -> (B, T, H/s, W/s, 3) frame by frame."""

    def __init__(self, scale: int = 4, nf: int = 64, n_layers: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(3, scale, nf, n_layers, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-3]
        x = x.reshape(-1, *x.shape[-3:])
        base = imresize(x, 1.0 / self.scale)
        y = self._layers(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = (y + base).to(torch.float32)
        return out.reshape(*lead, *out.shape[1:])
