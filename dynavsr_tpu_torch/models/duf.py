"""DUF: dynamic upsampling filters over a 3-D conv dense trunk (port of
dynavsr_tpu/models/duf.py).

A 3-D conv stem and dense trunk over the 7-frame stack, then two heads: a
per-pixel bank of R = scale^2 5x5 filters (softmaxed over the 25 taps, one
filter per output sub-pixel) applied to the centre frame, plus a residual;
depth-to-space by `scale`. The input must be blur-matched
(data/degradations.duf_downsample) and evaluation crops 8 border pixels.

Attribute names are the reference's (conv3d_1, dense1_{i}.bn1 / conv1 /
bn2 / conv2, dense2_{i}, bn3d_2, conv3d_2, conv3d_r1/_r2, conv3d_f1/_f2),
so a reference `.pth` loads with `load_state_dict` (BatchNorm buffers
included) and JAX params and batch_stats load through convert/from_jax.py.
Internally NCDHW; `forward` keeps the JAX package's NHWC layout at its
boundary: windows (B, 7, H, W, 3) in, SR (B, H*scale, W*scale, 3) fp32 out.

The BatchNorms keep flax's default momentum 0.99 (torch momentum 0.01),
which the JAX model does not override, unlike TOF's 0.9. With
`dtype=torch.bfloat16` the convs run in bf16 (the parameters stay fp32),
each BatchNorm in fp32 followed by ReLU and a cast to bf16, and the softmax
on bf16 logits; the centre frame stays fp32, so the filter application (K6
on the card) reads fp32 x and bf16 filters and writes fp32, and the
residual add and the pixel shuffle are fp32, as flax's promotion leaves
them in the JAX model. The JAX model's space-to-depth trunk (`s2d`,
dynavsr_tpu/ops/conv_s2d.py) computes the same output and is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynavsr_tpu_torch.models.arch_util import BatchNorm3d, Conv3d, variance_scaling_
from dynavsr_tpu_torch.ops.duf_filter import dynamic_upsampling_filter
from dynavsr_tpu_torch.ops.duf_filter_ref import TAPS
from dynavsr_tpu_torch.ops.pixelshuffle import pixel_shuffle

__all__ = ["DUF"]

_BN_MOMENTUM = 0.01  # flax.linen.BatchNorm's default momentum 0.99, in torch's terms
N_FRAMES = 7  # the three T-valid dense layers take T 7 -> 5 -> 3 -> 1


def _conv3d(cin: int, cout: int, kernel, t_valid: bool = False,
            dtype: Optional[torch.dtype] = None) -> Conv3d:
    """A stride-1 3-D conv, spatially 'same'; T padded (kt - 1) // 2 unless
    `t_valid` (the JAX `_conv3d` rule)."""
    kt, kh, kw = kernel
    pad_t = 0 if t_valid else (kt - 1) // 2
    c = Conv3d(cin, cout, kernel, 1, (pad_t, (kh - 1) // 2, (kw - 1) // 2),
               compute_dtype=dtype)
    variance_scaling_(c.weight, 1.0)  # flax's lecun_normal, zero bias
    nn.init.zeros_(c.bias)
    return c


def _bn_relu(bn: BatchNorm3d, y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """BatchNorm (fp32 inside), ReLU, cast to the compute dtype."""
    return F.relu(bn(y)).to(dtype)


class _DenseLayer(nn.Module):
    """bn-relu-conv1x1x1 -> bn-relu-conv3x3x3, concatenated to the input
    (cin -> cin + growth channels). With `t_valid` the 3x3x3 conv does not
    pad T, and the input is cut to the same T for the concat."""

    def __init__(self, cin: int, growth: int = 32, t_valid: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.t_valid = t_valid
        self.dtype = dtype
        self.bn1 = BatchNorm3d(cin, momentum=_BN_MOMENTUM)
        self.conv1 = _conv3d(cin, cin, (1, 1, 1), dtype=dtype)
        self.bn2 = BatchNorm3d(cin, momentum=_BN_MOMENTUM)
        self.conv2 = _conv3d(cin, growth, (3, 3, 3), t_valid, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        y = self.conv1(_bn_relu(self.bn1, x, dt))
        y = self.conv2(_bn_relu(self.bn2, y, dt))
        if self.t_valid:
            x = x[:, :, 1:-1]
        return torch.cat([x, y], dim=1)


class DUF(nn.Module):
    """DUF_16L / 28L / 52L via dense1_layers = 3 / 9 / 21.

    x (B, 7, H, W, 3) blur-matched LR frames -> (B, H*scale, W*scale, 3)."""

    arch = "DUF"  # its input convention (models/padding.py): raw LR, no padding

    def __init__(self, scale: int = 4, dense1_layers: int = 3, growth: int = 32,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = scale
        self.dense1_layers = dense1_layers
        self.dtype = dtype
        r2 = scale * scale
        self.conv3d_1 = _conv3d(3, 64, (1, 3, 3), dtype=dtype)
        cin = 64
        for i in range(dense1_layers):
            setattr(self, f"dense1_{i}", _DenseLayer(cin, growth, False, dtype))
            cin += growth
        for i in range(3):
            setattr(self, f"dense2_{i}", _DenseLayer(cin, growth, True, dtype))
            cin += growth
        self.bn3d_2 = BatchNorm3d(cin, momentum=_BN_MOMENTUM)
        self.conv3d_2 = _conv3d(cin, 256, (1, 3, 3), dtype=dtype)
        self.conv3d_r1 = _conv3d(256, 256, (1, 1, 1), dtype=dtype)
        self.conv3d_r2 = _conv3d(256, 3 * r2, (1, 1, 1), dtype=dtype)
        self.conv3d_f1 = _conv3d(256, 512, (1, 1, 1), dtype=dtype)
        self.conv3d_f2 = _conv3d(512, TAPS * r2, (1, 1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if t != N_FRAMES:
            raise ValueError(f"DUF takes {N_FRAMES} frames a window, got {t}")
        r2 = self.scale ** 2
        dt = self.dtype or x.dtype
        x_center = x[:, t // 2].permute(0, 3, 1, 2).contiguous()  # (B, 3, H, W), raw input
        fea = self.conv3d_1(x.permute(0, 4, 1, 2, 3))  # (B, 64, T, H, W)
        for i in range(self.dense1_layers):
            fea = getattr(self, f"dense1_{i}")(fea)
        for i in range(3):
            fea = getattr(self, f"dense2_{i}")(fea)
        fea = F.relu(self.conv3d_2(_bn_relu(self.bn3d_2, fea, dt)))
        res = self.conv3d_r2(F.relu(self.conv3d_r1(fea)))[:, :, 0]
        filt = self.conv3d_f2(F.relu(self.conv3d_f1(fea)))[:, :, 0]
        # Head channels k*R + r: (B, 25, R, H, W), softmax over the 25 taps.
        filt = F.softmax(filt.reshape(b, TAPS, r2, h, w), dim=1)
        out = dynamic_upsampling_filter(x_center, filt) + res
        return pixel_shuffle(out, self.scale).to(torch.float32).permute(0, 2, 3, 1)
