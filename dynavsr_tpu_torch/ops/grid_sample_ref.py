"""Bilinear sampling and flow warping in plain PyTorch (port of
dynavsr_tpu/ops/grid_sample.py): the plain version of the K4/K5 kernels.

Four taps, each with its inside-the-frame mask, so a sample near or past
the border fades to zero exactly like torch's F.grid_sample(bilinear,
zeros, align_corners=True). The corner weights come from floor of the
unclamped position; whether a corner is inside is decided in float, and the
index is clamped in float before it becomes an integer, so positions far
outside the frame give zeros and never overflow. Autograd is torch's own
(floor has no gradient, as under JAX autodiff).

The public functions keep the JAX package's layout: NHWC frames, coords as
(y, x), flows as (dx, dy). `warp_nchw` / `sample_nchw` are the same
arithmetic on NCHW planes, the layout the port's TOFlow holds inside.
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_sample", "grid_sample", "flow_warp", "sample_nchw", "warp_nchw",
           "flow_grid"]


def sample_nchw(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) sampled at ys / xs (B, Ho, Wo) -> (B, C, Ho, Wo)."""
    b, c, h, w = x.shape
    ho, wo = ys.shape[-2:]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    flat = x.reshape(b, c, h * w)

    def tap(yf, xf, wgt):
        inside = (yf >= 0) & (yf <= h - 1) & (xf >= 0) & (xf <= w - 1)
        idx = (yf.clamp(0, h - 1) * w + xf.clamp(0, w - 1)).long().reshape(b, 1, ho * wo)
        vals = torch.gather(flat, 2, idx.expand(b, c, ho * wo)).reshape(b, c, ho, wo)
        return vals * (wgt * inside)[:, None]

    out = tap(y0, x0, wy0 * wx0)
    out = out + tap(y0, x0 + 1, wy0 * wx1)
    out = out + tap(y0 + 1, x0, wy1 * wx0)
    return out + tap(y0 + 1, x0 + 1, wy1 * wx1)


def flow_grid(flow: torch.Tensor):
    """(ys, xs) = the pixel grid + flow, for flow (B, 2, H, W) as (dx, dy)."""
    h, w = flow.shape[-2:]
    gy = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    gx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, :]
    return gy + flow[:, 1], gx + flow[:, 0]


def warp_nchw(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) warped by flow (B, 2, H, W) as (dx, dy): output pixel
    (i, j) samples x at (i + dy, j + dx)."""
    return sample_nchw(x, *flow_grid(flow))


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img (H, W, C) sampled at float positions ys / xs (...) -> (..., C)."""
    lead = ys.shape
    x = img.permute(2, 0, 1)[None]
    out = sample_nchw(x, ys.reshape(1, 1, -1), xs.reshape(1, 1, -1))
    return out[0, :, 0].t().reshape(*lead, img.shape[-1])


def grid_sample(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C); coords (B, Ho, Wo, 2) as (y, x) pixel positions ->
    (B, Ho, Wo, C)."""
    out = sample_nchw(x.permute(0, 3, 1, 2), coords[..., 0], coords[..., 1])
    return out.permute(0, 2, 3, 1)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) warped by flow (B, H, W, 2) as (dx, dy) -> (B, H, W, C)."""
    out = warp_nchw(x.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1)
