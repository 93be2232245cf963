"""DUF's dynamic upsampling filter: the CUDA kernels and their autograd
(port of dynavsr_tpu/models/duf.py:dynamic_upsampling_filter).

A CUDA tensor always goes to the hand-written kernels of csrc/ — K6
`duf_fwd` and K7 `duf_bwd` — through `DufFilterFunction`; a CPU tensor
always goes to the plain version (ops/duf_filter_ref.py). Nothing falls back
from one to the other. The kernels take x in fp32 and the filters in fp32
or bf16 (DUF's filter head runs in bf16 in bf16 mode, while the centre
frame it filters stays fp32), and write fp32; grad filters comes back in
the filters' dtype.

Second order (DUF's meta-training, a gradient of a gradient): the filter
is bilinear in (x, filters), so the backward runs K7 through
`DufBwdFunction`, whose own backward is K6 / K7 again with their inputs
swapped; no other kernel is needed. With bf16 filters (DUF in bf16 mode)
the filter cotangent is bf16 too, and K6 / K7 take it as they take bf16
filters: fp32 sums, x and its gradients fp32, grad filters bf16, JAX's
rounding points for `dynamic_upsampling_filter` (an fp32-accumulated
product, its output in x's dtype). A first-order backward launches K7
once, as before; a third backward raises.

Layout: NCHW planes, the port's DUF's own (see duf_filter_ref.py).

Each launcher adds one to its module-level count where it launches its
kernel (`fwd_launches`, `bwd_launches`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynavsr_tpu_torch.ops import _build
from dynavsr_tpu_torch.ops.duf_filter_ref import TAPS, dynamic_upsampling_filter_ref

__all__ = ["dynamic_upsampling_filter", "DufFilterFunction", "DufBwdFunction", "duf_fwd",
           "duf_bwd", "launch_counts", "reset_launch_counts"]

fwd_launches = 0
bwd_launches = 0

_FILTER_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernels stage C x 12 x 36 floats of x in shared memory a block: 16
# channels (27 KB) stay under the 48 KB a launch gets without opting in.
_MAX_C = 16


def launch_counts() -> dict:
    return {"duf_fwd": fwd_launches, "duf_bwd": bwd_launches}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


def _check(x, filters, grad_out=None) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 4 or filters.dim() != 5 or filters.shape[1] != TAPS:
        raise ValueError(f"x must be (B, C, H, W) and filters (B, 25, R, H, W), got "
                         f"{tuple(x.shape)} and {tuple(filters.shape)}")
    if not x.is_cuda:
        raise ValueError(f"the DUF filter kernels take CUDA tensors; x is on {x.device}")
    b, c, h, w = x.shape
    r = filters.shape[2]
    if tuple(filters.shape) != (b, TAPS, r, h, w):
        raise ValueError(f"filters {tuple(filters.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= c <= _MAX_C or b > 65535 or h * w >= 2 ** 31:
        raise ValueError(f"x {tuple(x.shape)}: the kernels take 1-{_MAX_C} channels, at "
                         "most 65535 frames and H*W < 2^31")
    if x.dtype != torch.float32:
        raise ValueError(f"x dtype {x.dtype}: the DUF filter kernels take float32 x")
    if filters.dtype not in _FILTER_DTYPES:
        raise ValueError(f"filters dtype {filters.dtype}: the DUF filter kernels take "
                         "float32 or bfloat16 filters")
    if grad_out is not None:
        if tuple(grad_out.shape) != (b, c * r, h, w):
            raise ValueError(f"grad_out must be {(b, c * r, h, w)}, got {tuple(grad_out.shape)}")
        if grad_out.dtype != torch.float32:
            raise ValueError(f"grad_out dtype {grad_out.dtype}: the kernels take float32")
    for name, t in (("x", x), ("filters", filters), ("grad_out", grad_out)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} with x, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def duf_fwd(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA tensors: x (B, C, H, W) fp32 filtered by filters
    (B, 25, R, H, W) -> (B, C*R, H, W) fp32."""
    global fwd_launches
    _check(x, filters)
    b, c, h, w = x.shape
    r = filters.shape[2]
    out = torch.empty((b, c * r, h, w), dtype=torch.float32, device=x.device)
    rc = _build.load("duf_fwd").duf_fwd(x.data_ptr(), filters.data_ptr(), out.data_ptr(),
                                        b, c, r, h, w, _FILTER_DTYPES[filters.dtype],
                                        _build.stream(x))
    _build.raise_if(rc, "duf_fwd")
    fwd_launches += 1
    return out


def duf_bwd(x: torch.Tensor, filters: torch.Tensor, grad_out: torch.Tensor, need_x: bool
            ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K7 on CUDA tensors: (grad_x, or None unless `need_x`; grad_filters in
    the filters' dtype)."""
    global bwd_launches
    grad_out = grad_out.contiguous()
    _check(x, filters, grad_out)
    b, c, h, w = x.shape
    r = filters.shape[2]
    gx = torch.empty_like(x) if need_x else None
    gf = torch.empty_like(filters)
    rc = _build.load("duf_bwd").duf_bwd(
        x.data_ptr(), filters.data_ptr(), grad_out.data_ptr(), gf.data_ptr(),
        None if gx is None else gx.data_ptr(), b, c, r, h, w, _FILTER_DTYPES[filters.dtype],
        _build.stream(x))
    _build.raise_if(rc, "duf_bwd")
    bwd_launches += 1
    return gx, gf


class DufFilterFunction(torch.autograd.Function):
    """Forward K6; backward K7 (grad x only when x needs it) through
    DufBwdFunction, so that a create_graph=True backward records it."""

    @staticmethod
    def forward(ctx, x, filters):
        ctx.save_for_backward(x, filters)
        return duf_fwd(x, filters)

    @staticmethod
    def backward(ctx, grad_out):
        x, filters = ctx.saved_tensors
        gx, gf = DufBwdFunction.apply(x, filters, grad_out, ctx.needs_input_grad[0])
        return gx, gf if ctx.needs_input_grad[1] else None


class DufBwdFunction(torch.autograd.Function):
    """K7 as a function of (x, filters, grad_out) -> (grad x or None unless
    `need_x`, grad filters). Its backward along the cotangents (Cx, Cf) of
    K7's two outputs, the filter being bilinear in (x, filters):
      grad_out <- K6(Cx, filters) + K6(x, Cf)
      filters  <- K7(x:=Cx, filters, grad_out).grad_filters
      x        <- K7(x, filters:=Cf, grad_out).grad_x
    A cotangent that is None or all zero skips its launches; Cf is in the
    filters' dtype (fp32 or bf16), Cx in x's (fp32). A third backward
    raises."""

    @staticmethod
    def forward(ctx, x, filters, grad_out, need_x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, filters, grad_out)
        return duf_bwd(x, filters, grad_out, need_x=need_x)

    @staticmethod
    def backward(ctx, cx, cf):
        _build.refuse_double_backward("K6, K7 (the dynamic filter's second order)",
                                      "A third derivative of the filter is not planned.")
        x, filters, go = ctx.saved_tensors
        need = ctx.needs_input_grad
        cx, cf = _build.cotangents(cx, cf)
        gx = gf = ggo = None
        if cx is not None:
            cx = cx.contiguous()
            if need[2]:
                ggo = duf_fwd(cx, filters)
            if need[1]:
                gf = duf_bwd(cx, filters, go, need_x=False)[1]
        if cf is not None:
            cf = cf.contiguous()
            if need[2]:
                ggo = _build.accumulate(ggo, duf_fwd(x, cf))
            if need[0]:
                gx = duf_bwd(x, cf, go, need_x=True)[0]
        return gx, gf, ggo, None


def dynamic_upsampling_filter(x: torch.Tensor, filters: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) filtered by the per-pixel 5x5 filters (B, 25, R, H, W)
    -> (B, C*R, H, W), channel c*R + r. CUDA tensors run the kernels, CPU
    tensors the plain version."""
    if x.is_cuda:
        return DufFilterFunction.apply(x, filters)
    return dynamic_upsampling_filter_ref(x, filters)
