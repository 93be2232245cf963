"""Modulated deformable conv: the CUDA kernels and their autograd.

`deform_conv2d` is the entry the models call (port of
dynavsr_tpu/ops/dcn.py). A CUDA tensor always goes to the hand-written
kernels of csrc/ — K1 `dcn_fwd`, K2 `dcn_bwd_data`, K3 `dcn_bwd_weight` —
through `DeformConv2dFunction`; a CPU tensor always goes to the plain
version (ops/dcn_ref.py). Nothing falls back from one to the other.

Second order (meta-training's grad of a gradient, fp32): the backward runs
K2 and K3 through `DcnBwdDataFunction` and `DcnBwdWeightFunction`, whose
own backward is K1-K3 again on other inputs plus the terms along the
offset cotangent, K8 `dcn_fwd_tangent`, K9 `dcn_bwd_weight_tangent` and K10
`dcn_bwd_data_tangent` (csrc/dcn_tangent.cu). A first-order backward
launches K2 and K3 once each, as before; a third backward raises.

Each launcher adds one to its module-level count where it launches its
kernel (`fwd_launches`, `bwd_data_launches`, `bwd_weight_launches`,
`fwd_tangent_launches`, `bwd_weight_tangent_launches`,
`bwd_data_tangent_launches`), so a run can show that its path went through
the kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from dynavsr_tpu_torch.ops import _build
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref

__all__ = ["deform_conv2d", "DeformConv2dFunction", "DcnBwdDataFunction",
           "DcnBwdWeightFunction", "dcn_fwd", "dcn_bwd_data", "dcn_bwd_weight",
           "dcn_fwd_tangent", "dcn_bwd_weight_tangent", "dcn_bwd_data_tangent",
           "fwd_tangent_splits", "launch_counts", "reset_launch_counts"]

fwd_launches = 0
bwd_data_launches = 0
bwd_weight_launches = 0
fwd_tangent_launches = 0
bwd_weight_tangent_launches = 0
bwd_data_tangent_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_counts() -> dict:
    return {"dcn_fwd": fwd_launches, "dcn_bwd_data": bwd_data_launches,
            "dcn_bwd_weight": bwd_weight_launches, "dcn_fwd_tangent": fwd_tangent_launches,
            "dcn_bwd_weight_tangent": bwd_weight_tangent_launches,
            "dcn_bwd_data_tangent": bwd_data_tangent_launches}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_data_launches, bwd_weight_launches
    global fwd_tangent_launches, bwd_weight_tangent_launches, bwd_data_tangent_launches
    fwd_launches = bwd_data_launches = bwd_weight_launches = 0
    fwd_tangent_launches = bwd_weight_tangent_launches = bwd_data_tangent_launches = 0


def _check(x, offset, mask, gd: int, cout: int, weight=None, bias=None, grad_out=None,
           x_channels_last: bool = False, coff=None):
    """Raise on anything the kernels do not take. x is NCHW-contiguous, or
    with `x_channels_last` contiguous in torch.channels_last (the layout
    K1 gathers from and K2 and K3 read)."""
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
            "bias": (bias, (cout,)), "grad_out": (grad_out, (b, cout, h, w)),
            "coff": (coff, (b, 2 * gd * 9, h, w))}
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
    which K1 gathers from and K2/K3 read again. An NCHW x is copied to x_cl
    by K1's prologue; a channels-last x (as a conv may hand it over) is
    x_cl itself, and the prologue is skipped."""
    global fwd_launches
    b, c, h, w = x.shape
    cout = weight.shape[0]
    given_cl = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    _check(x, offset, mask, deformable_groups, cout, weight=weight, bias=bias,
           x_channels_last=given_cl)
    x_cl = x if given_cl else torch.empty_like(x, memory_format=torch.channels_last)
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
    """K1: the forward on CUDA tensors (3x3, stride 1, padding 1). x is
    NCHW or channels-last; the kernel samples a channels-last x (for an
    NCHW x its launcher writes that copy first), and takes the weight as (9, Cout, C) in bf16 (the tensor-core B
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


_SECOND_ORDER = "K1-K3, K8-K10 (the DCN's second order)"


def _tangent_args(x, offset, mask, coff, gd: int, cout: int, name: str, **tensors):
    """Checked inputs of K8-K10: x channels-last (a library copy when it is
    not; the autograd passes K1's), the rest contiguous; fp32 only."""
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"{name} takes float32 (the meta configs' dtype); a bf16 second order through the "
            "DCN is ROADMAP A.7")
    x = x.contiguous(memory_format=torch.channels_last)
    coff = coff.contiguous()
    tensors = {k: v.contiguous() for k, v in tensors.items()}
    _check(x, offset, mask, gd, cout, x_channels_last=True, coff=coff, **tensors)
    return x, coff, tensors


@functools.lru_cache(maxsize=None)
def fwd_tangent_splits(b: int, c: int, h: int, w: int, cout: int, gd: int, device: int) -> int:
    """How many blocks K8 splits a tile's taps over at this shape on the
    card with index `device` (1, 3 or 9; the launcher's choice, asked once
    a shape and card)."""
    with torch.cuda.device(device):
        return _build.load("dcn_tangent").dcn_fwd_tangent_splits(b, c, h, w, cout, gd)


def dcn_fwd_tangent(x, offset, mask, weight, coff, deformable_groups: int) -> torch.Tensor:
    """K8: W . (m x the derivative of the bilinear sample along coff), (B,
    Cout, H, W), no bias, on fp32 CUDA tensors. Where the launcher splits a
    tile's taps over blocks, the splits past the first sum into a scratch
    that a second pass adds to the output in a fixed order."""
    global fwd_tangent_launches
    b, c, h, w = x.shape
    cout = weight.shape[0]
    x, coff, t = _tangent_args(x, offset, mask, coff, deformable_groups, cout,
                               "K8 dcn_fwd_tangent", weight=weight)
    wt = t["weight"].permute(2, 3, 1, 0).reshape(9, c, cout).contiguous()
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    split = fwd_tangent_splits(b, c, h, w, cout, deformable_groups, x.get_device())
    part = None if split == 1 else torch.empty((split - 1) * out.numel(), dtype=x.dtype,
                                               device=x.device)
    rc = _build.load("dcn_tangent").dcn_fwd_tangent(
        x.data_ptr(), offset.data_ptr(), _ptr(mask), coff.data_ptr(), wt.data_ptr(),
        out.data_ptr(), _ptr(part), b, c, h, w, cout, deformable_groups, split,
        _build.stream(x))
    _build.raise_if(rc, "dcn_fwd_tangent")
    fwd_tangent_launches += 1
    return out


def dcn_bwd_weight_tangent(x, offset, mask, grad_out, coff, deformable_groups: int
                           ) -> torch.Tensor:
    """K9: sum over pixels of grad_out (x) the tangent columns, (Cout, C, 3,
    3), on fp32 CUDA tensors. Blocks sum with atomics into a (9, Cout, C)
    scratch, which a second pass writes out."""
    global bwd_weight_tangent_launches
    b, c, h, w = x.shape
    cout = grad_out.shape[1]
    x, coff, t = _tangent_args(x, offset, mask, coff, deformable_groups, cout,
                               "K9 dcn_bwd_weight_tangent", grad_out=grad_out)
    gsc = torch.empty(9 * cout * c, dtype=torch.float32, device=x.device)
    gw = torch.empty((cout, c, 3, 3), dtype=x.dtype, device=x.device)
    rc = _build.load("dcn_tangent").dcn_bwd_weight_tangent(
        x.data_ptr(), offset.data_ptr(), _ptr(mask), coff.data_ptr(), t["grad_out"].data_ptr(),
        gsc.data_ptr(), gw.data_ptr(), b, c, h, w, cout, deformable_groups, _build.stream(x))
    _build.raise_if(rc, "dcn_bwd_weight_tangent")
    bwd_weight_tangent_launches += 1
    return gw


def dcn_bwd_data_tangent(x, offset, mask, weight, grad_out, coff, deformable_groups: int):
    """K10: the gradient of <W^T . grad_out, tangent columns> with respect
    to (x, offset, mask), on fp32 CUDA tensors; grad x comes back NCHW-shaped
    with channels-last strides, grad mask None without a mask. The offset
    and mask gradients are stored once each (no atomics: bitwise the same
    from run to run); grad x is summed with atomics."""
    global bwd_data_tangent_launches
    b, c, h, w = x.shape
    cout = weight.shape[0]
    x, coff, t = _tangent_args(x, offset, mask, coff, deformable_groups, cout,
                               "K10 dcn_bwd_data_tangent", weight=weight, grad_out=grad_out)
    wt = t["weight"].permute(2, 3, 0, 1).reshape(9, cout, c).contiguous()
    gx = torch.empty((b, h, w, c), dtype=x.dtype, device=x.device)
    goff = torch.empty_like(offset)
    gmask = None if mask is None else torch.empty_like(mask)
    rc = _build.load("dcn_tangent").dcn_bwd_data_tangent(
        x.data_ptr(), offset.data_ptr(), _ptr(mask), coff.data_ptr(), wt.data_ptr(),
        t["grad_out"].data_ptr(), gx.data_ptr(), goff.data_ptr(), _ptr(gmask), b, c, h, w,
        cout, deformable_groups, 0, _build.stream(x))
    _build.raise_if(rc, "dcn_bwd_data_tangent")
    bwd_data_tangent_launches += 1
    return gx.permute(0, 3, 1, 2), goff, gmask


_cotangents, _acc = _build.cotangents, _build.accumulate


class DeformConv2dFunction(torch.autograd.Function):
    """Forward K1; backward K2 (x, offset, mask) and K3 (weight), which
    read the channels-last copy of x that K1 made, through
    DcnBwdDataFunction and DcnBwdWeightFunction so that a
    create_graph=True backward records them (meta-training's second
    order); the bias gradient is a plain sum of grad_out. x itself is saved
    too: a second-order gradient reaches x through it."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, deformable_groups):
        ctx.gd = deformable_groups
        ctx.has_bias = bias is not None
        out, x_cl = _fwd(x, offset, mask, weight, bias, deformable_groups)
        ctx.save_for_backward(x, x_cl, offset, mask, weight)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, x_cl, offset, mask, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        gx = goff = gmask = gw = gb = None
        if need[0] or need[1] or need[2]:
            gx, goff, gmask = DcnBwdDataFunction.apply(x, offset, mask, weight, grad_out,
                                                       ctx.gd, x_cl)
        if need[3]:
            gw = DcnBwdWeightFunction.apply(x, offset, mask, grad_out, ctx.gd, x_cl)
        if ctx.has_bias and need[4]:
            gb = grad_out.sum((0, 2, 3))
        return gx, goff, gmask, gw, gb, None


class DcnBwdDataFunction(torch.autograd.Function):
    """K2 as a function of (x, offset, mask, weight, grad_out); x_cl is x
    channels-last (K1's copy), the kernels' operand. Its backward, the
    DCN's second order along the cotangents (Cx, Coff, Cm) of K2's three
    outputs:
      grad_out <- K1(Cx, W) + K1(x, mask=Cm, W) + K8(x, W, Coff)
      weight   <- K3(Cx, grad_out) + K3(x, mask=Cm, grad_out) + K9(x, grad_out, Coff)
      x        <- K2(x, mask=Cm).gx + K10.gx
      offset   <- K2(Cx).goff + K2(x, mask=Cm).goff + K10.goff
      mask     <- K2(Cx).gmask + K10.gmask
    (every K1-K3 at the same offset, mask m unless stated). A cotangent
    that is None or all zero skips its launches. A third backward raises."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, grad_out, deformable_groups, x_cl):
        ctx.gd = deformable_groups
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_cl, offset, mask, weight, grad_out)
        return dcn_bwd_data(x_cl, offset, mask, weight, grad_out, deformable_groups)

    @staticmethod
    def backward(ctx, cx, coff, cm):
        _build.refuse_double_backward(_SECOND_ORDER, "A third derivative of the DCN is not "
                                      "planned.")
        x_cl, offset, mask, weight, go = ctx.saved_tensors
        need, gd = ctx.needs_input_grad, ctx.gd
        cx, coff, cm = _cotangents(cx, coff, None if mask is None else cm)
        if x_cl.dtype != torch.float32 and any(t is not None for t in (cx, coff, cm)):
            raise NotImplementedError("the DCN's second order takes float32; bf16 is "
                                      "ROADMAP A.7")
        weight = weight.contiguous()
        gx = goff = gmask = gw = ggo = None
        if cx is not None:
            cx = cx.contiguous()
            if need[4]:
                ggo = _acc(ggo, dcn_fwd(cx, offset, mask, weight, None, gd))
            if need[3]:
                gw = _acc(gw, dcn_bwd_weight(cx, offset, mask, go, gd))
            if need[1] or need[2]:
                _, t_off, t_mask = dcn_bwd_data(cx, offset, mask, weight, go, gd)
                goff, gmask = _acc(goff, t_off), _acc(gmask, t_mask)
        if cm is not None:
            cm = cm.contiguous()
            if need[4]:
                ggo = _acc(ggo, dcn_fwd(x_cl, offset, cm, weight, None, gd))
            if need[3]:
                gw = _acc(gw, dcn_bwd_weight(x_cl, offset, cm, go, gd))
            if need[0] or need[1]:
                t_x, t_off, _ = dcn_bwd_data(x_cl, offset, cm, weight, go, gd)
                gx, goff = _acc(gx, t_x), _acc(goff, t_off)
        if coff is not None:
            if need[4]:
                ggo = _acc(ggo, dcn_fwd_tangent(x_cl, offset, mask, weight, coff, gd))
            if need[3]:
                gw = _acc(gw, dcn_bwd_weight_tangent(x_cl, offset, mask, go, coff, gd))
            if need[0] or need[1] or need[2]:
                t_x, t_off, t_mask = dcn_bwd_data_tangent(x_cl, offset, mask, weight, go, coff,
                                                          gd)
                gx, goff = _acc(gx, t_x), _acc(goff, t_off)
                if t_mask is not None:
                    gmask = _acc(gmask, t_mask)
        return (gx if need[0] else None, goff if need[1] else None,
                gmask if need[2] else None, gw, ggo, None, None)


class DcnBwdWeightFunction(torch.autograd.Function):
    """K3 as a function of (x, offset, mask, grad_out); x_cl as in
    DcnBwdDataFunction. Its backward along the cotangent CW of grad weight:
      grad_out            <- K1(x, W=CW), no bias
      (x, offset, mask)   <- K2(x, W=CW, grad_out)
    A cotangent that is None or all zero skips its launches. A third
    backward raises."""

    @staticmethod
    def forward(ctx, x, offset, mask, grad_out, deformable_groups, x_cl):
        ctx.gd = deformable_groups
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_cl, offset, mask, grad_out)
        return dcn_bwd_weight(x_cl, offset, mask, grad_out, deformable_groups)

    @staticmethod
    def backward(ctx, cw):
        _build.refuse_double_backward(_SECOND_ORDER, "A third derivative of the DCN is not "
                                      "planned.")
        x_cl, offset, mask, go = ctx.saved_tensors
        need, gd = ctx.needs_input_grad, ctx.gd
        (cw,) = _cotangents(cw)
        if cw is None:
            return None, None, None, None, None, None
        if x_cl.dtype != torch.float32:
            raise NotImplementedError("the DCN's second order takes float32; bf16 is "
                                      "ROADMAP A.7")
        cw = cw.contiguous()
        gx = goff = gmask = ggo = None
        if need[3]:
            ggo = dcn_fwd(x_cl, offset, mask, cw, None, gd)
        if need[0] or need[1] or need[2]:
            gx, goff, gmask = dcn_bwd_data(x_cl, offset, mask, cw, go, gd)
        return (gx if need[0] else None, goff if need[1] else None,
                gmask if need[2] else None, ggo, None, None)


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
