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

`warp_fwd_tangent_ref` and `warp_bwd_tangent_ref` are the plain versions of
K11 and K12, the warp's second order (ops/grid_sample.py:WarpBwdFunction),
written out as explicit formulas over the four corners, as autograd of
`warp_nchw` differentiates it twice; `warp_tangents_ref` is both, as the
one kernel that computes them returns them. The tests hold them against
`torch.func.jvp` and double autograd; nothing on the card's path runs
them.
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_sample", "grid_sample", "flow_warp", "sample_nchw", "warp_nchw",
           "flow_grid", "warp_fwd_tangent_ref", "warp_bwd_tangent_ref", "warp_tangents_ref"]


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


def _corners(x: torch.Tensor, flow: torch.Tensor):
    """The four corners of each output pixel's sample, as warp_nchw takes
    them: (values v00, v01, v10, v11, each (B, C, H, W), 0 outside the
    frame; weights wy0, wy1, wx0, wx1, each (B, 1, H, W); flat indices
    (B, 1, H*W) and inside masks (B, 1, H, W) of the corners in that
    order)."""
    b, c, h, w = x.shape
    ys, xs = flow_grid(flow)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = (ys - y0)[:, None], (xs - x0)[:, None]
    flat = x.reshape(b, c, h * w)
    vals, idxs, masks = [], [], []
    for yf, xf in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        inside = ((yf >= 0) & (yf <= h - 1) & (xf >= 0) & (xf <= w - 1))[:, None]
        idx = (yf.clamp(0, h - 1) * w + xf.clamp(0, w - 1)).long().reshape(b, 1, h * w)
        v = torch.gather(flat, 2, idx.expand(b, c, h * w)).reshape(b, c, h, w)
        vals.append(v * inside)
        idxs.append(idx)
        masks.append(inside)
    return vals, (1.0 - wy1, wy1, 1.0 - wx1, wx1), idxs, masks


def warp_fwd_tangent_ref(x: torch.Tensor, flow: torch.Tensor, cflow: torch.Tensor
                         ) -> torch.Tensor:
    """K11's function: the warp's derivative along a flow tangent,
    T = d out / d flow_x * cflow_x + d out / d flow_y * cflow_y, (B, C, H, W).
    x (B, C, H, W); flow, cflow (B, 2, H, W) as (dx, dy)."""
    (v00, v01, v10, v11), (wy0, wy1, wx0, wx1), _, _ = _corners(x, flow)
    d_dx = wy0 * (v01 - v00) + wy1 * (v11 - v10)
    d_dy = wx0 * (v10 - v00) + wx1 * (v11 - v01)
    return d_dx * cflow[:, 0:1] + d_dy * cflow[:, 1:2]


def warp_bwd_tangent_ref(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
                         cflow: torch.Tensor, need_x: bool):
    """K12's function: the gradient of <cflow, grad flow>, grad flow being
    K5's (sum_c grad_out * d out / d flow), with respect to flow and, with
    `need_x`, to x -> (grad x or None, grad flow).

    In the flow, only the cross derivative of a bilinear sample is nonzero
    off the grid lines: d^2 out / d flow_x d flow_y = v00 - v01 - v10 + v11,
    so grad flow_x = sum_c grad_out * cross * cflow_y and grad flow_y the
    same with cflow_x. In x it is a scatter of grad_out times each corner
    weight's derivative along cflow into the four corners (inside the frame
    only)."""
    (v00, v01, v10, v11), (wy0, wy1, wx0, wx1), idxs, masks = _corners(x, flow)
    cross = (grad_out * (v00 - v01 - v10 + v11)).sum(1)
    gflow = torch.stack((cross * cflow[:, 1], cross * cflow[:, 0]), dim=1)
    if not need_x:
        return None, gflow
    b, c, h, w = x.shape
    cx, cy = cflow[:, 0:1], cflow[:, 1:2]
    # d(corner weight)/d flow along cflow, corners 00, 01, 10, 11.
    dweights = (-cx * wy0 - cy * wx0, cx * wy0 - cy * wx1, -cx * wy1 + cy * wx0,
                cx * wy1 + cy * wx1)
    gx = torch.zeros(b, c, h * w, dtype=x.dtype, device=x.device)
    for dw, idx, inside in zip(dweights, idxs, masks):
        src = (grad_out * dw * inside).reshape(b, c, h * w)
        gx.scatter_add_(2, idx.expand(b, c, h * w), src)
    return gx.reshape(b, c, h, w), gflow


def warp_tangents_ref(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
                      cflow: torch.Tensor, need_x: bool, need_t: bool = False):
    """K12's function with K11's beside it, as ops/grid_sample.warp_bwd_tangent
    returns them: (grad x or None unless `need_x`, grad flow, T or None
    unless `need_t`)."""
    gx, gflow = warp_bwd_tangent_ref(x, flow, grad_out, cflow, need_x)
    return gx, gflow, warp_fwd_tangent_ref(x, flow, cflow) if need_t else None


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
