"""Shared building blocks, NCHW / NCDHW (port of dynavsr_tpu/models/arch_util.py).

`Conv2d` and `Conv3d` add the JAX package's bf16 compute option to torch's
convs: with `compute_dtype=torch.bfloat16` the parameters stay fp32 and are
cast, with the input, to bf16 for the conv, whose output stays bf16 (flax
`nn.Conv(dtype=bfloat16)` semantics). Residual trunks are `nn.Sequential`s
with the reference's `{name}.{i}.conv1.weight` keys; the JAX package stacks
the same tensors on a leading axis (nn.scan). `BatchNorm2d` and
`BatchNorm3d` are flax's BatchNorm under torch's state_dict keys.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["Conv2d", "Conv3d", "conv", "BatchNorm2d", "BatchNorm3d", "ResidualBlockNoBN", "ResTrunk", "lrelu",
           "interpolate_bilinear", "max_pool_3x3_s2", "avg_pool_3x3_s2", "avg_pool2"]


class _ComputeDtype:
    """A torch conv with an optional compute dtype (None: the input's)."""

    def __init__(self, *args, compute_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class Conv2d(_ComputeDtype, nn.Conv2d):
    """nn.Conv2d with an optional compute dtype."""


class Conv3d(_ComputeDtype, nn.Conv3d):
    """nn.Conv3d with an optional compute dtype."""


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         dtype: Optional[torch.dtype] = None) -> Conv2d:
    """Conv with torch-style symmetric padding (kernel - 1) // 2."""
    return Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, compute_dtype=dtype)


class _FlaxBatchNorm:
    """Batch normalisation as the JAX package's flax `nn.BatchNorm` (eps
    1e-5), with torch's parameters, buffers and state_dict keys, so a
    reference `.pth` loads.

    Two differences from torch's BatchNorm: the statistics and the
    normalisation are computed in fp32 whatever the input's dtype, and the
    train-mode update of `running_var` uses the *biased* batch variance
    (flax: ra_var = m ra_var + (1 - m) var, no Bessel factor; torch would
    take var * n / (n - 1)). `momentum` is torch's, 1 - flax's: TOF's
    BatchNorms set flax momentum 0.9 (torch 0.1, the default here), DUF's
    keep flax's default 0.99 (torch 0.01). The output has the input's
    dtype. In eval mode, running statistics that require grad (adaptation
    in bn_mode 'grad_stats') get gradients: the formula is written out
    there, since the fused op is not differentiable in them."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x if x.dtype == torch.float64 else x.float()  # float64 stays (a reference run)
        if not self.training:
            if self.running_mean.requires_grad or self.running_var.requires_grad:
                # Adaptation in bn_mode 'grad_stats' differentiates in the
                # running statistics, which F.batch_norm refuses; this is
                # flax's eval formula, (x - mean) * (rsqrt(var + eps) * w) + b.
                shape = (1, -1) + (1,) * (x.dim() - 2)
                mul = torch.rsqrt(self.running_var + self.eps) * self.weight
                y = (x32 - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
            else:
                y = F.batch_norm(x32, self.running_mean, self.running_var, self.weight,
                                 self.bias, False, 0.0, self.eps)
            return y.to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x32, dim=(0, *range(2, x.dim())), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(x.dtype)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """Flax's BatchNorm over (B, C, H, W), `nn.BatchNorm2d`'s keys."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """Flax's BatchNorm over (B, C, T, H, W), `nn.BatchNorm3d`'s keys."""


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class ResidualBlockNoBN(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 + identity."""

    def __init__(self, nf: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv(nf, nf, dtype=dtype)
        self.conv2 = conv(nf, nf, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x)))


class ResTrunk(nn.Sequential):
    """`n_blocks` ResidualBlockNoBN in sequence."""

    def __init__(self, nf: int = 64, n_blocks: int = 10, dtype: Optional[torch.dtype] = None):
        super().__init__(*[ResidualBlockNoBN(nf, dtype) for _ in range(n_blocks)])


def interpolate_bilinear(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear resize of (..., C, H, W) by an integer factor, half-pixel
    centres (align_corners=False)."""
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, *x.shape[-3:]), scale_factor=scale,
                      mode="bilinear", align_corners=False)
    return y.reshape(*lead, *y.shape[-3:])


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """nn.MaxPool2d(3, stride=2, padding=1)."""
    return F.max_pool2d(x, 3, 2, 1)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """nn.AvgPool2d(3, stride=2, padding=1), count_include_pad=True."""
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool (SpyNet's pyramid)."""
    return F.avg_pool2d(x, 2)
