"""TOFlow: SpyNet coarse-to-fine flow, warp, fusion (port of
dynavsr_tpu/models/tof.py).

Attribute names are the reference's (spynet.block{l}.conv{i} / bn{i},
conv_3x7_64_9x9, ...), so a reference `.pth` loads with `load_state_dict`
(BatchNorm buffers included) and JAX params and batch_stats load through
convert/from_jax.py. Internally NCHW; `forward` keeps the JAX package's
NHWC layout at its boundary: windows (B, T, H, W, 3) in, the refined
centre frame (B, H, W, 3) fp32 out.

The convs are plain convs: the JAX model's space-to-depth schedule
(`s2d_conv`, dynavsr_tpu/ops/conv_s2d.py) computes the same output and is
not ported yet. With `dtype=torch.bfloat16` only the convs run in bf16 (the
parameters stay fp32); the normalised frames, the flows, every warp and the
output stay fp32, as flax's promotion leaves them in the JAX model.

Neighbours are flowed and warped one after another: in train mode each of
the T - 1 SpyNet calls takes its own batch statistics and moves the running
statistics by one EMA step, as the JAX model does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.models.arch_util import (BatchNorm2d, Conv2d, avg_pool2, conv,
                                                 interpolate_bilinear, variance_scaling_)
from dynavsr_tpu_torch.ops.grid_sample import warp_nchw

__all__ = ["SpyNetBlock", "SpyNet", "TOFlow"]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class SpyNetBlock(nn.Module):
    """One pyramid level's flow refiner: 5 7x7 convs (8 -> 32 -> 64 -> 32
    -> 16 -> 2), BatchNorm + ReLU after the first four."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = (32, 64, 32, 16, 2)
        cin = 8
        for i, f in enumerate(widths):
            setattr(self, f"conv{i}", conv(cin, f, 7, dtype=dtype))
            if i < 4:
                setattr(self, f"bn{i}", BatchNorm2d(f))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.conv4(x)


class SpyNet(nn.Module):
    """4-level coarse-to-fine flow estimator. ref, nbr (B, 3, H, W)
    normalised frames -> flow (B, 2, H, W) as (dx, dy), fp32: the
    displacement that warps nbr onto ref."""

    def __init__(self, levels: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.levels = levels
        for lvl in range(levels):
            setattr(self, f"block{lvl}", SpyNetBlock(dtype))

    def forward(self, ref: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        refs, nbrs = [ref], [nbr]
        for _ in range(self.levels - 1):
            refs.insert(0, avg_pool2(refs[0]))
            nbrs.insert(0, avg_pool2(nbrs[0]))
        b, _, h0, w0 = refs[0].shape
        flow = torch.zeros((b, 2, h0, w0), dtype=ref.dtype, device=ref.device)
        for lvl in range(self.levels):
            if lvl > 0:
                flow = interpolate_bilinear(flow, 2) * 2.0
            warped = warp_nchw(nbrs[lvl], flow)
            inp = torch.cat([refs[lvl], warped, flow], dim=1)
            flow = flow + getattr(self, f"block{lvl}")(inp)
        return flow


class TOFlow(nn.Module):
    """TOFlow: normalise, flow each neighbour onto the centre frame, warp,
    fuse. x (B, T, H, W, 3) in [0, 1], bicubically pre-upscaled unless
    `pre_upscale` folds the MATLAB-bicubic x`scale` upscale into the module
    (then x is raw LR). Returns the refined centre frame (B, H', W', 3)."""

    arch = "TOF"  # its input convention (models/padding.py)

    def __init__(self, dtype: Optional[torch.dtype] = None, pre_upscale: bool = False,
                 scale: int = 4, nframes: int = 7):
        super().__init__()
        self.pre_upscale = pre_upscale
        self.scale = scale
        # Non-persistent buffers: they move with .to(device), stay out of the
        # state_dict, and cost the forward no host-to-device copy.
        self.register_buffer("mean", torch.tensor(_MEAN).view(3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_STD).view(3, 1, 1), persistent=False)
        self.spynet = SpyNet(dtype=dtype)
        self.conv_3x7_64_9x9 = conv(nframes * 3, 64, 9, dtype=dtype)
        self.conv_64_64_9x9 = conv(64, 64, 9, dtype=dtype)
        self.conv_64_64_1x1 = conv(64, 64, 1, dtype=dtype)
        self.conv_64_3_1x1 = conv(64, 3, 1, dtype=dtype)
        for m in self.modules():  # flax's lecun_normal (conv gives the zero bias)
            if isinstance(m, Conv2d):
                variance_scaling_(m.weight, 1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_upscale:
            b0, t0, h0, w0, c0 = x.shape
            x = imresize(x.reshape(b0 * t0, h0, w0, c0), float(self.scale)).reshape(
                b0, t0, h0 * self.scale, w0 * self.scale, c0)
        b, t, h, w, c = x.shape
        center = t // 2
        mean, std = self.mean.to(x.dtype), self.std.to(x.dtype)
        # (T, B, 3, H, W): each frame a contiguous batch of NCHW planes.
        xn = ((x.permute(1, 0, 4, 2, 3) - mean) / std).contiguous()
        ref = xn[center]
        warped = [ref if i == center else warp_nchw(xn[i], self.spynet(ref, xn[i]))
                  for i in range(t)]
        # Frame-major channels, as torch's .view(B, T*C, H, W).
        y = torch.stack(warped, dim=1).reshape(b, t * c, h, w)
        y = F.relu(self.conv_3x7_64_9x9(y))
        y = F.relu(self.conv_64_64_9x9(y))
        y = F.relu(self.conv_64_64_1x1(y))
        y = self.conv_64_3_1x1(y)
        out = (y + ref) * std + mean
        return out.to(torch.float32).permute(0, 2, 3, 1)
