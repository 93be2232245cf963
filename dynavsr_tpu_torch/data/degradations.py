"""Degradation synthesis (port of dynavsr_tpu/data/degradations.py): random
Gaussian blur kernels, blur + downsample, MATLAB-bicubic downsample, DUF's
blur-matched downsample, and the (LR, SLR) pairs that MFDN / SFDN training
and meta-training are built from.

DynaVSR trains its downscalers and meta-trains the VSR net on synthetic
degradations: one random isotropic or anisotropic Gaussian kernel k per
clip, LR = (HR * k) downsampled and SLR = (LR * k) downsampled (the same
kernel twice). The batch is synthesised on its own device: the blur is a
depthwise `F.conv2d` (`groups=C`) in fp32 (TF32 is off on the card,
device.py), the subsample its stride.

Random draws take an explicit `torch.Generator` on the batch's device.
JAX's PRNG stream cannot be reproduced without JAX, so the draws differ
from the JAX package's; the draw structure is the same (sigma_iso,
(sigma_x, sigma_y), theta in [0, pi), the aniso choice; then the noise),
and `random_kernel_batch` builds its kernels from `isotropic_kernel` /
`anisotropic_kernel`, which match JAX's from the same parameters.

DUF expects LR frames made by `duf_downsample` (configs/test/test_DUF_Vid4.yml):
a fixed 13x13 Gaussian of sigma 0.4 * scale, reflect padding, stride
`scale`, and a 2-pixel crop.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dynavsr_tpu_torch.data.resize import imresize

__all__ = ["isotropic_kernel", "anisotropic_kernel", "random_kernel_params",
           "kernels_from_params", "random_kernel_batch", "blur_downsample",
           "bicubic_downsample", "duf_downsample", "synthesize_pair"]


def _grid(size: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, x) coordinates of a size x size kernel, centred, fp32."""
    ax = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    return torch.meshgrid(ax, ax, indexing="ij")


def _as_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def isotropic_kernel(size: int, sigma) -> torch.Tensor:
    """Normalised isotropic Gaussian: a float sigma gives (size, size), a
    tensor of sigmas (...) gives (..., size, size)."""
    dev = sigma.device if torch.is_tensor(sigma) else None
    y, x = _grid(size, dev)
    s = _as_f32(sigma, dev)[..., None, None]
    k = torch.exp(-(x * x + y * y) / (2.0 * s ** 2))
    return k / k.sum((-2, -1), keepdim=True)


def anisotropic_kernel(size: int, sigma_x, sigma_y, theta) -> torch.Tensor:
    """Normalised anisotropic Gaussian: axis sigmas and a rotation theta
    (floats, or tensors of one shape (...) -> (..., size, size))."""
    dev = next((v.device for v in (sigma_x, sigma_y, theta) if torch.is_tensor(v)), None)
    y, x = _grid(size, dev)
    sx, sy, th = (_as_f32(v, dev)[..., None, None] for v in (sigma_x, sigma_y, theta))
    ct, st = torch.cos(th), torch.sin(th)
    xr = ct * x + st * y  # coordinates in the kernel's frame
    yr = -st * x + ct * y
    k = torch.exp(-0.5 * ((xr / sx) ** 2 + (yr / sy) ** 2))
    return k / k.sum((-2, -1), keepdim=True)


def random_kernel_params(gen: torch.Generator, batch: int,
                         sigma_range: Tuple[float, float] = (0.2, 4.0),
                         aniso_prob: float = 0.5) -> Dict[str, torch.Tensor]:
    """The draws of `random_kernel_batch`, on gen's device, in JAX's
    order: sigma_iso (B,), sigma_xy (B, 2) from U(sigma_range), theta (B,)
    from U(0, pi), and aniso (B,) = U(0, 1) < aniso_prob."""
    dev = gen.device
    lo, hi = sigma_range

    def uniform(*shape, a=0.0, b=1.0):
        return a + (b - a) * torch.rand(*shape, generator=gen, device=dev)

    return {"sigma_iso": uniform(batch, a=lo, b=hi), "sigma_xy": uniform(batch, 2, a=lo, b=hi),
            "theta": uniform(batch, b=math.pi), "aniso": uniform(batch) < aniso_prob}


def kernels_from_params(params: Dict[str, torch.Tensor], size: int = 13) -> torch.Tensor:
    """(B, size, size): the anisotropic kernel where `aniso`, else the
    isotropic one."""
    iso = isotropic_kernel(size, params["sigma_iso"])
    aniso = anisotropic_kernel(size, params["sigma_xy"][:, 0], params["sigma_xy"][:, 1],
                               params["theta"])
    return torch.where(params["aniso"][:, None, None], aniso, iso)


def random_kernel_batch(gen: torch.Generator, batch: int, size: int = 13,
                        sigma_range: Tuple[float, float] = (0.2, 4.0),
                        aniso_prob: float = 0.5) -> torch.Tensor:
    """(batch, size, size) random Gaussian kernels on gen's device: an
    isotropic sigma ~ U(range), or independent axis sigmas and a uniform
    rotation, chosen with aniso_prob."""
    return kernels_from_params(random_kernel_params(gen, batch, sigma_range, aniso_prob), size)


def blur_downsample(x: torch.Tensor, kernel: torch.Tensor, scale: int) -> torch.Tensor:
    """(x * kernel) subsampled at grid points 0, s, 2s, ... .

    x: (B, H, W, C) or (B, T, H, W, C); kernel (k, k) shared, or (B, k, k)
    one per sample (repeated over a clip's T frames). Reflect padding of
    k // 2 centres the blur; the depthwise conv runs in fp32."""
    video = x.dim() == 5
    if video:
        b, t = x.shape[:2]
        x = x.reshape(b * t, *x.shape[2:])
        if kernel.dim() == 3:
            kernel = kernel.repeat_interleave(t, dim=0)
    n, _, _, c = x.shape
    kh, kw = kernel.shape[-2:]
    xp = F.pad(x.permute(0, 3, 1, 2).to(torch.float32), (kw // 2, kw // 2, kh // 2, kh // 2),
               mode="reflect")
    k = kernel.to(device=x.device, dtype=torch.float32)
    if k.dim() == 2:
        out = F.conv2d(xp, k.expand(c, 1, kh, kw), stride=scale, groups=c)
    else:  # per-sample kernels: the samples folded into the channels
        out = F.conv2d(xp.reshape(1, n * c, *xp.shape[2:]),
                       k.repeat_interleave(c, dim=0).unsqueeze(1), stride=scale, groups=n * c)
        out = out.reshape(n, c, *out.shape[2:])
    out = out.permute(0, 2, 3, 1).to(x.dtype)
    return out.reshape(b, t, *out.shape[1:]) if video else out


def bicubic_downsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """MATLAB-bicubic downscale by 1/scale (antialiased), (..., H, W, C)."""
    return imresize(x, 1.0 / scale, antialiasing=True)


def synthesize_pair(gen: torch.Generator, hr: torch.Tensor, scale: int, size: int = 13,
                    sigma_range: Tuple[float, float] = (0.2, 4.0), aniso_prob: float = 0.5,
                    noise_range: Tuple[float, float] = (0.0, 0.0),
                    share: Optional[Tuple[int, int]] = None):
    """(LR, SLR, kernels) from an HR clip batch (B, T, H, W, C) on gen's
    device: one random kernel per clip, shared by its frames, applied
    twice. The kernels are drawn first, so their draw does not depend on
    noise_range. With noise_range[1] > 0 a per-clip sigma ~ U(noise_range)
    of additive Gaussian noise is put on LR, which is clipped to [0, 1];
    SLR is then the blur-down of the noisy LR (the JAX package's
    beyond-reference extension). share = (first row, global batch): hr is
    rows [first, first + B) of a global batch, and every draw is made for
    the global batch and cut to those rows, so a rank of a data-parallel
    run degrades its rows as the one-process run does."""
    b = hr.shape[0]
    first, total = share or (0, b)
    rows = slice(first, first + b)
    kernels = random_kernel_batch(gen, total, size, sigma_range, aniso_prob)[rows]
    lr = blur_downsample(hr, kernels, scale)
    if noise_range[1] > 0.0:
        lo, hi = noise_range
        nsig = (lo + (hi - lo) * torch.rand(total, generator=gen, device=gen.device))[rows]
        noise = torch.randn((total,) + tuple(lr.shape[1:]), generator=gen, device=gen.device,
                            dtype=lr.dtype)[rows]
        lr = (lr + nsig.view(b, *(1,) * (lr.dim() - 1)).to(lr.dtype) * noise).clamp(0.0, 1.0)
    slr = blur_downsample(lr, kernels, scale)
    return lr, slr, kernels


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
