"""Modulated deformable conv v2 — plain PyTorch version (port of
dynavsr_tpu/ops/dcn_ref.py, NCHW).

  out(p) = b + sum_k w_k * m_k(p) * x(p*stride - pad + d*k + dp_k(p))

Bilinear sampling where each corner outside the image contributes zero
(the CUDA reference's dmcn_im2col_bilinear rule), offsets interleaved
(dy, dx) per (deformable group, tap): channel 2*(g*K + k) is dy and
2*(g*K + k) + 1 is dx. Sampling positions are fp32 for every input dtype;
the columns (mask x bilinear sample) are formed in fp32, and the
contraction accumulates in fp32; the result is returned in x's dtype. A
float64 x (a reference run) computes everything in float64.
With `compute_dtype=torch.bfloat16` the columns and the weights are rounded
to bf16 before the contraction: K1's function in bf16 (its tensor-core
product takes bf16 operands), and the rounding point of JAX's
deform_conv2d_fused, which casts its columns to the compute dtype. The
rounding is straight-through: the gradients of x, offset and mask flow
through the fp32 columns (grad_col = sum_o W_bf16 * grad_out, as K2 computes
it), while grad weight = sum_p grad_out * round_bf16(columns) takes the
rounded ones (K3's function, and JAX's, whose weight gradient sees its cast
columns). Its autograd is the CPU backward and the oracle the CUDA kernels
(ops/dcn.py) are held against.

The second order (3x3, stride 1, padding 1): a double backward of the
DCN needs, besides K1-K3 on other inputs, the terms along a cotangent
`coff` of the offsets. With the tangent columns

  tcol[b,c,k,p] = m * D_coff bilinear(x[b,c], pos) = m * sum_corners
                  x[corner] * (coff_y * dw/dy + coff_x * dw/dx)

`dcn_fwd_tangent_ref` is W . tcol (K8), `dcn_bwd_weight_tangent_ref` is
grad_out (x) tcol (K9), and `dcn_bwd_data_tangent_ref` is the gradient of
<gc, tcol>, gc = W^T . grad_out, with respect to x, offset and mask (K10):
x gets gc * m * (coff . dw/dpos) scattered to each corner; the offsets get
gc * m * h * (coff_x, coff_y), h = x00 - x01 - x10 + x11 being the only
nonzero second derivative of the bilinear sample (d2/dy dx); the mask gets
sum_c gc * D_coff bilinear(x). They are explicit formulas, for the tests
and for holding the kernels on the card; the CPU path differentiates
`deform_conv2d_ref` itself. With `compute_dtype=torch.bfloat16` they are
K8-K10's bf16 function, at K1-K3's rounding points: the tangent columns are
formed in fp32 and rounded to bf16 before the products of K8 (against the
bf16-rounded weight) and K9 (against grad_out), as K1 and K3 round their
columns; K10's gc = W^T . grad_out is the fp32 product of the rounded
weight, as K2's is; sums are fp32 and the results come back in x's dtype.
The double autograd of `deform_conv2d_ref(..., compute_dtype=bf16)` takes
the tangent columns unrounded (its rounding is straight-through), so the
two differ by one bf16 rounding of those columns.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["deform_conv2d_ref", "dcn_fwd_tangent_ref", "dcn_bwd_weight_tangent_ref",
           "dcn_bwd_data_tangent_ref"]


def _out_size(size: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (size + 2 * pad - dil * (k - 1) - 1) // stride + 1


def _round_through(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to `dtype` (values in fp32), with t's own gradient."""
    return t + (t.to(dtype).to(t.dtype) - t).detach()


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
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """x (B, Cin, H, W); offset (B, 2*Gd*K, Ho, Wo); mask (B, Gd*K, Ho, Wo)
    post-sigmoid or None; weight OIHW (Cout, Cin, kh, kw); conv groups 1.
    compute_dtype: the operand dtype of the contraction (None: fp32)."""
    b, cin, h, w = x.shape
    cout, cin_w, kh, kw = weight.shape
    if cin_w != cin:
        raise ValueError("conv groups > 1 are not supported")
    k = kh * kw
    gd = deformable_groups
    cg = cin // gd
    ho = _out_size(h, kh, stride, padding, dilation)
    wo = _out_size(w, kw, stride, padding, dilation)
    f32 = torch.float64 if x.dtype == torch.float64 else torch.float32
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
    wmat = weight.to(f32).reshape(cout, cin, k)
    if compute_dtype is not None and compute_dtype not in (torch.float32, torch.float64):
        cols, wmat = _round_through(cols, compute_dtype), _round_through(wmat, compute_dtype)
    out = torch.einsum("bckp,ock->bop", cols, wmat)
    if bias is not None:
        out = out + bias.to(f32).view(1, -1, 1)
    return out.view(b, cout, ho, wo).to(x.dtype)


# The four bilinear corners: (dy, dx) from (y0, x0), the signs of d w / dy
# and d w / dx, and the corner's sign in h = x00 - x01 - x10 + x11.
_CORNERS = ((0, 0, -1.0, -1.0, 1.0), (0, 1, -1.0, 1.0, -1.0), (1, 0, 1.0, -1.0, -1.0),
            (1, 1, 1.0, 1.0, 1.0))


def _acc(x):
    """The dtype the tangent formulas compute in: float64 for a float64 x
    (a reference run), else fp32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _rounded(t, compute_dtype):
    """t rounded to compute_dtype and back, where that is bf16 (K8 / K9's
    tensor-core operands); else t."""
    if compute_dtype is None or compute_dtype in (torch.float32, torch.float64):
        return t
    return t.to(compute_dtype).to(t.dtype)


def _tangent_corners(x, offset, coff, gd):
    """Per corner of every (pixel, tap, group) sample of a 3x3 / stride 1 /
    padding 1 DCN: (flat index into the (H*W) plane, clamped; its values
    (B, Gd, Cg, 9, P) x inside; its tangent weight coff . dw/dpos
    (B, Gd, 1, 9, P) x inside; its sign in h x inside)."""
    b, c, h, w = x.shape
    f32, dev, k = _acc(x), x.device, 9
    p = h * w
    oy = torch.arange(h, dtype=f32, device=dev).view(h, 1).expand(h, w).reshape(p)
    ox = torch.arange(w, dtype=f32, device=dev).view(1, w).expand(h, w).reshape(p)
    ty = torch.arange(k, device=dev).div(3, rounding_mode="floor").to(f32) - 1.0
    tx = torch.arange(k, device=dev).remainder(3).to(f32) - 1.0
    off = offset.to(f32).view(b, gd, k, 2, p)
    cof = coff.to(f32).view(b, gd, k, 2, p)
    ys = oy.view(1, 1, 1, p) + ty.view(1, 1, k, 1) + off[:, :, :, 0]
    xs = ox.view(1, 1, 1, p) + tx.view(1, 1, k, 1) + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    cy, cx = cof[:, :, :, 0], cof[:, :, :, 1]
    imgs = x.to(f32).reshape(b, gd, c // gd, p)
    out = []
    for dy, dx, sy, sx, sh in _CORNERS:
        yi, xi = y0 + dy, x0 + dx
        inside = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).to(f32)
        wy = ly if dy else 1.0 - ly
        wx = lx if dx else 1.0 - lx
        tw = (cy * sy * wx + cx * sx * wy) * inside
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = torch.gather(imgs, 3, idx.view(b, gd, 1, k * p).expand(-1, -1, c // gd, -1))
        vals = vals.view(b, gd, c // gd, k, p) * inside.view(b, gd, 1, k, p)
        out.append((idx, vals, tw.view(b, gd, 1, k, p), sh * inside.view(b, gd, 1, k, p)))
    return out


def _mask5(mask, b, gd, p, dtype=torch.float32):
    return None if mask is None else mask.to(dtype).view(b, gd, 1, 9, p)


def _tangent_cols(x, offset, mask, coff, gd):
    """tcol (B, C, 9, P): m x the derivative of the bilinear sample along coff."""
    b, c, h, w = x.shape
    tcol = sum(vals * tw for _, vals, tw, _ in _tangent_corners(x, offset, coff, gd))
    m = _mask5(mask, b, gd, h * w, _acc(x))
    if m is not None:
        tcol = tcol * m
    return tcol.reshape(b, c, 9, h * w)


def dcn_fwd_tangent_ref(x, offset, mask, weight, coff, deformable_groups: int = 1,
                        compute_dtype=None):
    """K8's function: W . tcol, (B, Cout, H, W), no bias (compute_dtype
    bf16: both rounded to bf16 first)."""
    b, c, h, w = x.shape
    f = _acc(x)
    tcol = _rounded(_tangent_cols(x, offset, mask, coff, deformable_groups), compute_dtype)
    wmat = _rounded(weight.to(f).reshape(-1, c, 9), compute_dtype)
    out = torch.einsum("bckp,ock->bop", tcol, wmat)
    return out.reshape(b, -1, h, w).to(x.dtype)


def dcn_bwd_weight_tangent_ref(x, offset, mask, grad_out, coff, deformable_groups: int = 1,
                               compute_dtype=None):
    """K9's function: sum over pixels of grad_out (x) tcol, (Cout, C, 3, 3)
    (compute_dtype bf16: tcol rounded to bf16 first)."""
    b, c, h, w = x.shape
    tcol = _rounded(_tangent_cols(x, offset, mask, coff, deformable_groups), compute_dtype)
    go = grad_out.to(_acc(x)).reshape(b, -1, h * w)
    return torch.einsum("bckp,bop->ock", tcol, go).reshape(-1, c, 3, 3).to(x.dtype)


def dcn_bwd_data_tangent_ref(x, offset, mask, weight, grad_out, coff,
                             deformable_groups: int = 1, compute_dtype=None):
    """K10's function: the gradient of <W^T . grad_out, tcol> with respect
    to (x, offset, mask); grad mask is None when mask is None
    (compute_dtype bf16: W rounded to bf16 in gc)."""
    b, c, h, w = x.shape
    gd, p, f32 = deformable_groups, h * w, _acc(x)
    gc = torch.einsum("ock,bop->bckp", _rounded(weight.to(f32).reshape(-1, c, 9), compute_dtype),
                      grad_out.to(f32).reshape(b, -1, p)).reshape(b, gd, c // gd, 9, p)
    m = _mask5(mask, b, gd, p, f32)
    gcm = gc if m is None else gc * m
    cof = coff.to(f32).view(b, gd, 9, 2, p)
    gx = torch.zeros(b, gd, c // gd, p, dtype=f32, device=x.device)
    hsum, dsum = 0.0, 0.0
    for idx, vals, tw, sh in _tangent_corners(x, offset, coff, gd):
        src = (gcm * tw).reshape(b, gd, c // gd, 9 * p)
        gx.scatter_add_(3, idx.view(b, gd, 1, 9 * p).expand_as(src), src)
        hsum = hsum + vals * sh
        dsum = dsum + vals * tw
    hterm = (gcm * hsum).sum(2)  # (B, Gd, 9, P)
    goff = torch.stack([hterm * cof[:, :, :, 1], hterm * cof[:, :, :, 0]], dim=3)
    gmask = None if mask is None else (gc * dsum).sum(2).reshape(b, gd * 9, h, w).to(x.dtype)
    return (gx.reshape(b, c, h, w).to(x.dtype), goff.reshape(b, 2 * gd * 9, h, w).to(x.dtype),
            gmask)
