"""Bilinear sampling and flow warping: the CUDA kernels and their autograd
(port of dynavsr_tpu/ops/grid_sample.py).

A CUDA tensor always goes to the hand-written kernels of csrc/ — K4
`warp_fwd` and K5 `warp_bwd` — through `WarpFunction`; a CPU tensor always
goes to the plain version (ops/grid_sample_ref.py). Nothing falls back from
one to the other. The kernels take fp32 only: TOFlow keeps its frames, flows
and warps in fp32 in bf16 mode too, as the JAX model does.

Second order (TOF's meta-training, a gradient of a gradient): the backward
runs K5 through `WarpBwdFunction`, whose own backward is K4 / K5 on other
inputs plus the terms along the flow cotangent, K11's T and K12's
gradients, which one kernel computes in one launch (csrc/warp_tangent.cu;
`warp_bwd_tangent`, or `warp_fwd_tangent` for T alone). A first-order
backward launches K5 once, as before; a third backward raises.

`warp_nchw` is what TOFlow calls, on NCHW planes (the kernels' own layout,
so no permute copy around a launch). `flow_warp` keeps the JAX package's
NHWC layout and permutes around the kernels. The JAX package's
`grid_sample` (absolute positions) has no caller on the port's paths: its
plain version is `grid_sample_ref.grid_sample`.

Each launcher adds one to its module-level count where it launches its
kernel (`fwd_launches`, `bwd_launches`, `fwd_tangent_launches`,
`bwd_tangent_launches`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynavsr_tpu_torch.ops import _build, grid_sample_ref

__all__ = ["warp_nchw", "flow_warp", "WarpFunction", "WarpBwdFunction", "warp_fwd", "warp_bwd",
           "warp_fwd_tangent", "warp_bwd_tangent", "launch_counts", "reset_launch_counts"]

fwd_launches = 0
bwd_launches = 0
fwd_tangent_launches = 0
bwd_tangent_launches = 0


def launch_counts() -> dict:
    return {"warp_fwd": fwd_launches, "warp_bwd": bwd_launches,
            "warp_fwd_tangent": fwd_tangent_launches, "warp_bwd_tangent": bwd_tangent_launches}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches, fwd_tangent_launches, bwd_tangent_launches
    fwd_launches = bwd_launches = fwd_tangent_launches = bwd_tangent_launches = 0


def _check(x, flow, grad_out=None, cflow=None) -> None:
    """Raise on anything the kernels do not take."""
    if x.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"x must be (B, C, H, W) and flow (B, 2, H, W), got "
                         f"{tuple(x.shape)} and {tuple(flow.shape)}")
    if not x.is_cuda:
        raise ValueError(f"the warp kernels take CUDA tensors; x is on {x.device}")
    b, c, h, w = x.shape
    if tuple(flow.shape) != (b, 2, h, w):
        raise ValueError(f"flow {tuple(flow.shape)} does not fit x {tuple(x.shape)}")
    if b * max(c, 2) * h * w >= 2 ** 31:
        raise ValueError("tensor too large for the kernels' 32-bit plane indexing")
    if b > 65535:
        raise ValueError(f"x has {b} frames: the kernels' grid takes at most 65535")
    for name, t in (("x", x), ("flow", flow), ("grad_out", grad_out), ("cflow", cflow)):
        if t is None:
            continue
        if name == "grad_out" and t.shape != x.shape:
            raise ValueError(f"grad_out must be {tuple(x.shape)}, got {tuple(t.shape)}")
        if name == "cflow" and t.shape != flow.shape:
            raise ValueError(f"cflow must be {tuple(flow.shape)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device} with x, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} dtype {t.dtype}: the warp kernels take float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def warp_fwd(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors: x (B, C, H, W) warped by flow (B, 2, H, W)."""
    global fwd_launches
    _check(x, flow)
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    rc = _build.load("warp_fwd").warp_fwd(x.data_ptr(), flow.data_ptr(), out.data_ptr(),
                                          b, c, h, w, _build.stream(x))
    _build.raise_if(rc, "warp_fwd")
    fwd_launches += 1
    return out


def warp_bwd(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor, need_x: bool
             ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """K5 on CUDA tensors: (grad_x, or None unless `need_x`; grad_flow)."""
    global bwd_launches
    grad_out = grad_out.contiguous()
    _check(x, flow, grad_out)
    b, c, h, w = x.shape
    gx = torch.zeros_like(x) if need_x else None
    gflow = torch.empty_like(flow)
    rc = _build.load("warp_bwd").warp_bwd(
        x.data_ptr(), flow.data_ptr(), grad_out.data_ptr(),
        None if gx is None else gx.data_ptr(), gflow.data_ptr(), b, c, h, w,
        _build.stream(x))
    _build.raise_if(rc, "warp_bwd")
    bwd_launches += 1
    return gx, gflow


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _tangent_launch(x, flow, grad_out, cflow, t_out, gx, gflow) -> None:
    """The K11 / K12 kernel, computing the outputs that are not None."""
    b, c, h, w = x.shape
    rc = _build.load("warp_tangent").warp_bwd_tangent(
        x.data_ptr(), flow.data_ptr(), _ptr(grad_out), cflow.data_ptr(), _ptr(t_out), _ptr(gx),
        _ptr(gflow), b, c, h, w, _build.stream(x))
    _build.raise_if(rc, "warp_bwd_tangent")


def warp_fwd_tangent(x: torch.Tensor, flow: torch.Tensor, cflow: torch.Tensor) -> torch.Tensor:
    """K11 on CUDA tensors: the warp's derivative along the flow tangent
    cflow (B, 2, H, W), (B, C, H, W): the K11 / K12 kernel with T alone."""
    global fwd_tangent_launches
    cflow = cflow.contiguous()
    _check(x, flow, cflow=cflow)
    out = torch.empty_like(x)
    _tangent_launch(x, flow, None, cflow, out, None, None)
    fwd_tangent_launches += 1
    return out


def warp_bwd_tangent(x: torch.Tensor, flow: torch.Tensor, grad_out: torch.Tensor,
                     cflow: torch.Tensor, need_x: bool, need_t: bool = False
                     ) -> Tuple[Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
    """K12 on CUDA tensors, with K11 in the same launch on request: (the
    gradient of <cflow, K5's grad flow> in x, or None unless `need_x`; its
    gradient in flow; T = warp_fwd_tangent(x, flow, cflow), or None unless
    `need_t`)."""
    global bwd_tangent_launches
    grad_out, cflow = grad_out.contiguous(), cflow.contiguous()
    _check(x, flow, grad_out, cflow)
    gx = torch.zeros_like(x) if need_x else None
    gflow = torch.empty_like(flow)
    t = torch.empty_like(x) if need_t else None
    _tangent_launch(x, flow, grad_out, cflow, t, gx, gflow)
    bwd_tangent_launches += 1
    return gx, gflow, t


class WarpFunction(torch.autograd.Function):
    """Forward K4; backward K5 (grad x only when x needs it) through
    WarpBwdFunction, so that a create_graph=True backward records it."""

    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        return warp_fwd(x, flow)

    @staticmethod
    def backward(ctx, grad_out):
        x, flow = ctx.saved_tensors
        gx, gflow = WarpBwdFunction.apply(x, flow, grad_out, ctx.needs_input_grad[0])
        return gx, gflow if ctx.needs_input_grad[1] else None


class WarpBwdFunction(torch.autograd.Function):
    """K5 as a function of (x, flow, grad_out) -> (grad x or None unless
    `need_x`, grad flow). Its backward, the warp's second order along the
    cotangents (Cx, Cf) of K5's two outputs:
      grad_out <- K4(Cx, flow) + K11(x, flow, Cf)
      flow     <- K5(Cx, flow, grad_out).grad_flow + K12(x, flow, grad_out, Cf).grad_flow
      x        <- K12(...).grad_x
    K11 and K12 are one launch where both are needed (warp_bwd_tangent
    with need_t). A cotangent that is None or all zero skips its launches.
    A third backward raises."""

    @staticmethod
    def forward(ctx, x, flow, grad_out, need_x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, flow, grad_out)
        return warp_bwd(x, flow, grad_out, need_x=need_x)

    @staticmethod
    def backward(ctx, cx, cflow):
        _build.refuse_double_backward("K4, K5, K11, K12 (the warp's second order)",
                                      "A third derivative of the warp is not planned.")
        x, flow, go = ctx.saved_tensors
        need = ctx.needs_input_grad
        cx, cflow = _build.cotangents(cx, cflow)
        gx = gflow = ggo = None
        if cx is not None:
            cx = cx.contiguous()
            if need[2]:
                ggo = warp_fwd(cx, flow)
            if need[1]:
                gflow = warp_bwd(cx, flow, go, need_x=False)[1]
        if cflow is not None:
            if need[0] or need[1]:
                gx, t_flow, t = warp_bwd_tangent(x, flow, go, cflow, need_x=need[0],
                                                 need_t=need[2])
                gflow = _build.accumulate(gflow, t_flow)
            elif need[2]:
                t = warp_fwd_tangent(x, flow, cflow)
            if need[2]:
                ggo = _build.accumulate(ggo, t)
        return gx, gflow if need[1] else None, ggo, None


def warp_nchw(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (B, C, H, W) warped by flow (B, 2, H, W) as (dx, dy): output pixel
    (i, j) samples x at (i + dy, j + dx), zeros outside. CUDA tensors run
    the kernels, CPU tensors the plain version."""
    if x.is_cuda:
        return WarpFunction.apply(x, flow)
    return grid_sample_ref.warp_nchw(x, flow)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) warped by flow (B, H, W, 2) as (dx, dy) -> (B, H, W, C)."""
    if not x.is_cuda:
        return grid_sample_ref.flow_warp(x, flow)
    out = warp_nchw(x.permute(0, 3, 1, 2).contiguous(), flow.permute(0, 3, 1, 2).contiguous())
    return out.permute(0, 2, 3, 1)
