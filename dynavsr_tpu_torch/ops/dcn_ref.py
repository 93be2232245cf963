"""Modulated deformable conv v2 — plain PyTorch version (port of
dynavsr_tpu/ops/dcn_ref.py, NCHW).

  out(p) = b + sum_k w_k * m_k(p) * x(p*stride - pad + d*k + dp_k(p))

Bilinear sampling where each corner outside the image contributes zero
(the CUDA reference's dmcn_im2col_bilinear rule), offsets interleaved
(dy, dx) per (deformable group, tap): channel 2*(g*K + k) is dy and
2*(g*K + k) + 1 is dx. Sampling positions are fp32 for every input dtype;
the columns and the contraction accumulate in fp32 and the result is
returned in x's dtype. Its autograd is the CPU backward and the oracle the
CUDA kernels (ops/dcn.py) are held against.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["deform_conv2d_ref"]


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def deform_conv2d_ref(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    deformable_groups: int = 1,
) -> torch.Tensor:
    """x (B, Cin, H, W); offset (B, 2*Gd*K, Ho, Wo); mask (B, Gd*K, Ho, Wo)
    post-sigmoid or None; weight OIHW (Cout, Cin, kh, kw); conv groups 1."""
    b, cin, h, w = x.shape
    cout, cin_w, kh, kw = weight.shape
    if cin_w != cin:
        raise ValueError("conv groups > 1 are not supported")
    k = kh * kw
    gd = deformable_groups
    cg = cin // gd
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    f32 = torch.float32
    dev = x.device

    oy = torch.arange(ho, dtype=f32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=f32, device=dev) * stride - padding
    ty = torch.arange(kh, dtype=f32, device=dev) * dilation
    tx = torch.arange(kw, dtype=f32, device=dev) * dilation
    base_y = (oy.view(ho, 1, 1, 1) + ty.view(1, 1, kh, 1)).expand(ho, wo, kh, kw)
    base_x = (ox.view(1, wo, 1, 1) + tx.view(1, 1, 1, kw)).expand(ho, wo, kh, kw)
    base_y = base_y.reshape(ho, wo, k).permute(2, 0, 1)  # (K, Ho, Wo)
    base_x = base_x.reshape(ho, wo, k).permute(2, 0, 1)

    off = offset.to(f32).view(b, gd, k, 2, ho, wo)
    ys = base_y.view(1, 1, k, ho, wo) + off[:, :, :, 0]
    xs = base_x.view(1, 1, k, ho, wo) + off[:, :, :, 1]

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    imgs = x.reshape(b, gd, cg, h * w)

    def tap(yi, xi, wt):
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(f32)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (yc * w + xc).reshape(b, gd, 1, -1).expand(b, gd, cg, k * ho * wo)
        vals = torch.gather(imgs, 3, idx).view(b, gd, cg, k, ho, wo).to(f32)
        return vals * (wt * inside).view(b, gd, 1, k, ho, wo)

    cols = (tap(y0, x0, wy0 * wx0) + tap(y0, x0 + 1, wy0 * wx1)
            + tap(y0 + 1, x0, wy1 * wx0) + tap(y0 + 1, x0 + 1, wy1 * wx1))
    if mask is not None:
        cols = cols * mask.to(f32).view(b, gd, 1, k, ho, wo)
    cols = cols.reshape(b, cin, k, ho * wo)
    out = torch.einsum("bckp,ock->bop", cols, weight.to(f32).reshape(cout, cin, k))
    if bias is not None:
        out = out + bias.to(f32).view(1, -1, 1)
    return out.view(b, cout, ho, wo).to(x.dtype)
