"""Shared building blocks, NCHW / NCDHW (port of dynavsr_tpu/models/arch_util.py).

`Conv2d` and `Conv3d` add the JAX package's bf16 compute option to torch's
convs: with `compute_dtype=torch.bfloat16` the parameters stay fp32 and are
cast, with the input, to bf16 for the conv, whose output stays bf16 (flax
`nn.Conv(dtype=bfloat16)` semantics). Residual trunks are `nn.Sequential`s
with the reference's `{name}.{i}.conv1.weight` keys; the JAX package stacks
the same tensors on a leading axis (nn.scan). `BatchNorm2d` and
`BatchNorm3d` are flax's BatchNorm under torch's state_dict keys.

Initial weights follow the JAX package's initialisers, not torch's
defaults: every conv bias starts at zero (flax's default); `conv` keeps
torch's default weights, which are the JAX package's `variance_scaling(1/3,
"fan_in", "uniform")`; residual blocks draw kaiming-normal weights scaled by
0.1 (`kaiming_scaled(0.1)`); `variance_scaling_` gives flax's truncated
normals (`lecun_normal` is scale 1).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dynavsr_tpu_torch.parallel import mesh

__all__ = ["Conv2d", "Conv3d", "conv", "variance_scaling_", "BatchNorm2d", "BatchNorm3d", "global_batch_stats",
           "ResidualBlockNoBN", "ResTrunk", "lrelu", "interpolate_bilinear", "max_pool_3x3_s2",
           "avg_pool_3x3_s2", "avg_pool2"]


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


def variance_scaling_(w: torch.Tensor, scale: float) -> torch.Tensor:
    """flax's `variance_scaling(scale, "fan_in", "truncated_normal")` in
    place: a normal cut at two deviations whose variance is scale / fan_in
    (fan_in: the input channels times the kernel's taps)."""
    std = math.sqrt(scale / w[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


def conv(cin: int, cout: int, kernel: int = 3, stride: int = 1,
         dtype: Optional[torch.dtype] = None) -> Conv2d:
    """Conv with torch-style symmetric padding (kernel - 1) // 2 and a zero
    bias."""
    c = Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2, compute_dtype=dtype)
    nn.init.zeros_(c.bias)
    return c


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
    there, since the fused op is not differentiable in them. Under
    global_batch_stats, train mode normalises with the global batch's
    statistics across the ranks of a torch.distributed group."""

    global_stats = False  # set by global_batch_stats

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
        if self.global_stats and mesh.get_world_size() > 1:
            return self._global_batch_forward(x32).to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x32, dim=(0, *range(2, x.dim())), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(x.dtype)

    def _global_batch_forward(self, x32: torch.Tensor) -> torch.Tensor:
        """Train mode when the ranks hold shares of one batch
        (global_batch_stats): the statistics are the global batch's, as in
        JAX's sharded step. The mean, then the biased
        variance about it, are each one differentiable all-reduce of local
        sums (the element count rides with the first), so the gradient
        reaches every rank's input through them."""
        dims = (0, *range(2, x32.dim()))
        shape = (1, -1) + (1,) * (x32.dim() - 2)
        count = x32.new_tensor([x32.numel() // x32.shape[1]])
        total = mesh.all_reduce_sum(torch.cat([x32.sum(dims), count]))
        n = total[-1].detach()
        mean = total[:-1] / n
        xc = x32 - mean.view(shape)
        var = mesh.all_reduce_sum((xc * xc).sum(dims)) / n
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return xc * mul.view(shape) + self.bias.view(shape)


@contextlib.contextmanager
def global_batch_stats(model: nn.Module):
    """Within the block the ranks hold shares of one global batch, and every
    BatchNorm of `model` normalises in train mode with the global batch's
    statistics (the data-parallel train step). Elsewhere (serving,
    clip-parallel adaptation, where each rank's clips are its own) each
    rank's statistics are its own."""
    bns = [m for m in model.modules() if isinstance(m, _FlaxBatchNorm)]
    for m in bns:
        m.global_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.global_stats = False


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """Flax's BatchNorm over (B, C, H, W), `nn.BatchNorm2d`'s keys."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """Flax's BatchNorm over (B, C, T, H, W), `nn.BatchNorm3d`'s keys."""


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


class ResidualBlockNoBN(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 + identity; convs kaiming-normal * 0.1."""

    def __init__(self, nf: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv(nf, nf, dtype=dtype)
        self.conv2 = conv(nf, nf, dtype=dtype)
        with torch.no_grad():
            for c in (self.conv1, self.conv2):
                variance_scaling_(c.weight, 2.0).mul_(0.1)

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
