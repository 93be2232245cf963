"""Modulated deformable conv: the CUDA kernels and their autograd.

`deform_conv2d` is the entry the models call (port of
dynavsr_tpu/ops/dcn.py). A CUDA tensor always goes to the hand-written
kernels of csrc/ — K1 `dcn_fwd`, K2 `dcn_bwd_data`, K3 `dcn_bwd_weight` —
through `DeformConv2dFunction`; a CPU tensor always goes to the plain
version (ops/dcn_ref.py). Nothing falls back from one to the other.

Each launcher adds one to its module-level count where it launches its
kernel (`fwd_launches`, `bwd_data_launches`, `bwd_weight_launches`), so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynavsr_tpu_torch.ops import _build
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref

__all__ = ["deform_conv2d", "DeformConv2dFunction", "dcn_fwd", "dcn_bwd_data",
           "dcn_bwd_weight", "launch_counts", "reset_launch_counts"]

fwd_launches = 0
bwd_data_launches = 0
bwd_weight_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_counts() -> dict:
    return {"dcn_fwd": fwd_launches, "dcn_bwd_data": bwd_data_launches,
            "dcn_bwd_weight": bwd_weight_launches}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_data_launches, bwd_weight_launches
    fwd_launches = bwd_data_launches = bwd_weight_launches = 0


def _check(x, offset, mask, gd: int, cout: int, weight=None, bias=None, grad_out=None,
           x_channels_last: bool = False):
    """Raise on anything the kernels do not take. x is NCHW-contiguous, or
    with `x_channels_last` contiguous in torch.channels_last (the layout
    K2 and K3 read)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if not x.is_cuda:
        raise ValueError(f"the DCN kernels take CUDA tensors; x is on {x.device}")
    b, c, h, w = x.shape
    if gd < 1 or c % gd:
        raise ValueError(f"channels {c} not divisible by deformable_groups {gd}")
    if b * max(c, cout, 2 * gd * 9) * h * w >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' 32-bit pixel indexing")
    want = {"x": (x, (b, c, h, w)), "offset": (offset, (b, 2 * gd * 9, h, w)),
            "mask": (mask, (b, gd * 9, h, w)), "weight": (weight, (cout, c, 3, 3)),
            "bias": (bias, (cout,)), "grad_out": (grad_out, (b, cout, h, w))}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} with x, got {t.device}")
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} dtype {t.dtype}: all inputs must share one of "
                             "float32 / bfloat16")
        fmt = torch.channels_last if name == "x" and x_channels_last else torch.contiguous_format
        if not t.is_contiguous(memory_format=fmt):
            raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd(x, offset, mask, weight, bias, deformable_groups: int):
    """K1 on CUDA tensors: (out, x_cl), x_cl being x in torch.channels_last,
    the copy K1's launcher makes for its gather and K2/K3 read again."""
    global fwd_launches
    b, c, h, w = x.shape
    cout = weight.shape[0]
    _check(x, offset, mask, deformable_groups, cout, weight=weight, bias=bias)
    x_cl = torch.empty_like(x, memory_format=torch.channels_last)
    if x.dtype == torch.bfloat16:
        wt = weight.permute(2, 3, 0, 1).reshape(9, cout, c).contiguous()
    else:
        wt = weight.permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    lib = _build.load("dcn_fwd")
    rc = lib.dcn_fwd(x.data_ptr(), x_cl.data_ptr(), offset.data_ptr(), _ptr(mask), wt.data_ptr(),
                     _ptr(bias), out.data_ptr(), b, c, h, w, cout, deformable_groups,
                     _DTYPES[x.dtype], _build.stream(x))
    _build.raise_if(rc, "dcn_fwd")
    fwd_launches += 1
    return out, x_cl


def dcn_fwd(x, offset, mask, weight, bias, deformable_groups: int) -> torch.Tensor:
    """K1: the forward on CUDA tensors (3x3, stride 1, padding 1). The
    kernel samples a channels-last copy of x (its launcher writes it
    first), and takes the weight as (9, Cout, C) in bf16 (the tensor-core B
    operand) or (9, C, Cout) in fp32."""
    return _fwd(x, offset, mask, weight, bias, deformable_groups)[0]


def dcn_bwd_data(x, offset, mask, weight, grad_out, deformable_groups: int):
    """K2: (grad_x, grad_offset, grad_mask) on CUDA tensors, in x's dtype
    (grad_mask is None when mask is None). K2 reads x channels-last: the
    autograd passes K1's copy; an NCHW x costs one library copy here. One
    launch also zeroes the fp32 channels-last scratch that grad x is summed
    into and writes grad x out of it as NCHW."""
    global bwd_data_launches
    b, c, h, w = x.shape
    cout = weight.shape[0]
    x = x.contiguous(memory_format=torch.channels_last)  # K1's copy already is
    grad_out = grad_out.contiguous()
    _check(x, offset, mask, deformable_groups, cout, weight=weight, grad_out=grad_out,
           x_channels_last=True)
    if x.dtype == torch.bfloat16:  # the tensor-core B operand: [c][o] per tap
        wt = weight.permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    else:
        wt = weight.permute(2, 3, 0, 1).reshape(9, cout, c).contiguous()
    scratch = torch.empty((b, h, w, c), dtype=torch.float32, device=x.device)
    gx = torch.empty((b, c, h, w), dtype=x.dtype, device=x.device)
    goff = torch.empty_like(offset)
    gmask = None if mask is None else torch.empty_like(mask)
    lib = _build.load("dcn_bwd")
    rc = lib.dcn_bwd_data(x.data_ptr(), offset.data_ptr(), _ptr(mask), wt.data_ptr(),
                          grad_out.data_ptr(), scratch.data_ptr(), gx.data_ptr(),
                          goff.data_ptr(), _ptr(gmask), b, c, h, w, cout, deformable_groups,
                          _DTYPES[x.dtype], _build.stream(x))
    _build.raise_if(rc, "dcn_bwd_data")
    bwd_data_launches += 1
    return gx, goff, gmask


def dcn_bwd_weight(x, offset, mask, grad_out, deformable_groups: int) -> torch.Tensor:
    """K3: grad_weight (Cout, C, 3, 3) on CUDA tensors, in x's dtype. One
    launch also zeroes its fp32 (9, Cout, C) scratch and writes it out."""
    global bwd_weight_launches
    b, c, h, w = x.shape
    cout = grad_out.shape[1]
    x = x.contiguous(memory_format=torch.channels_last)  # K1's copy already is
    grad_out = grad_out.contiguous()
    _check(x, offset, mask, deformable_groups, cout, grad_out=grad_out, x_channels_last=True)
    scratch = torch.empty((9, cout, c), dtype=torch.float32, device=x.device)
    gw = torch.empty((cout, c, 3, 3), dtype=x.dtype, device=x.device)
    lib = _build.load("dcn_bwd")
    rc = lib.dcn_bwd_weight(x.data_ptr(), offset.data_ptr(), _ptr(mask), grad_out.data_ptr(),
                            scratch.data_ptr(), gw.data_ptr(), b, c, h, w, cout,
                            deformable_groups, _DTYPES[x.dtype], _build.stream(x))
    _build.raise_if(rc, "dcn_bwd_weight")
    bwd_weight_launches += 1
    return gw


class DeformConv2dFunction(torch.autograd.Function):
    """Forward K1; backward K2 (x, offset, mask) and K3 (weight), which
    read the channels-last copy of x that K1 made (saved in place of x);
    the bias gradient is a plain sum of grad_out. First order only: a
    double backward raises (`_build.refuse_double_backward`)."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, deformable_groups):
        ctx.gd = deformable_groups
        ctx.has_bias = bias is not None
        out, x_cl = _fwd(x, offset, mask, weight, bias, deformable_groups)
        ctx.save_for_backward(x_cl, offset, mask, weight)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        _build.refuse_double_backward("K2 dcn_bwd_data / K3 dcn_bwd_weight")
        x, offset, mask, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = goff = gmask = gw = gb = None
        if need[0] or need[1] or need[2]:
            gx, goff, gmask = dcn_bwd_data(x, offset, mask, weight, grad_out, ctx.gd)
        if need[3]:
            gw = dcn_bwd_weight(x, offset, mask, grad_out, ctx.gd)
        if ctx.has_bias and need[4]:
            gb = grad_out.sum((0, 2, 3))
        return gx, goff, gmask, gw, gb, None


def deform_conv2d(
    x: torch.Tensor,
    offset: torch.Tensor,
    mask: Optional[torch.Tensor],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    deformable_groups: int = 1,
) -> torch.Tensor:
    """Modulated (mask given) or plain deformable conv, 3x3, stride 1,
    padding 1. x (B, C, H, W); offset (B, 2*Gd*9, H, W) interleaved
    (dy, dx) per (group, tap); mask (B, Gd*9, H, W) post-sigmoid; weight
    OIHW. CUDA tensors run the kernels, CPU tensors the plain version, which
    contracts in x's dtype as K1 does (bf16 columns and weights, fp32
    accumulation)."""
    if x.is_cuda:
        return DeformConv2dFunction.apply(x, offset, mask, weight, bias, deformable_groups)
    return deform_conv2d_ref(x, offset, mask, weight, bias,
                             deformable_groups=deformable_groups, compute_dtype=x.dtype)
