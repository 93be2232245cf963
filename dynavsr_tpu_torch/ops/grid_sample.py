"""Bilinear sampling and flow warping: the CUDA kernels and their autograd
(port of dynavsr_tpu/ops/grid_sample.py).

A CUDA tensor always goes to the hand-written kernels of csrc/ — K4
`warp_fwd` and K5 `warp_bwd` — through `WarpFunction`; a CPU tensor always
goes to the plain version (ops/grid_sample_ref.py). Nothing falls back from
one to the other. The kernels take fp32 only: TOFlow keeps its frames, flows
and warps in fp32 in bf16 mode too, as the JAX model does.

`warp_nchw` is what TOFlow calls, on NCHW planes (the kernels' own layout,
so no permute copy around a launch). `flow_warp` keeps the JAX package's
NHWC layout and permutes around the kernels. The JAX package's
`grid_sample` (absolute positions) has no caller on the port's paths: its
plain version is `grid_sample_ref.grid_sample`.

Each launcher adds one to its module-level count where it launches its
kernel (`fwd_launches`, `bwd_launches`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dynavsr_tpu_torch.ops import _build, grid_sample_ref

__all__ = ["warp_nchw", "flow_warp", "WarpFunction", "warp_fwd", "warp_bwd", "launch_counts",
           "reset_launch_counts"]

fwd_launches = 0
bwd_launches = 0


def launch_counts() -> dict:
    return {"warp_fwd": fwd_launches, "warp_bwd": bwd_launches}


def reset_launch_counts() -> None:
    global fwd_launches, bwd_launches
    fwd_launches = bwd_launches = 0


def _check(x, flow, grad_out=None) -> None:
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
    for name, t in (("x", x), ("flow", flow), ("grad_out", grad_out)):
        if t is None:
            continue
        if name == "grad_out" and t.shape != x.shape:
            raise ValueError(f"grad_out must be {tuple(x.shape)}, got {tuple(t.shape)}")
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


class WarpFunction(torch.autograd.Function):
    """Forward K4; backward K5 (grad x only when x needs it). First order
    only: a double backward raises (`_build.refuse_double_backward`)."""

    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        return warp_fwd(x, flow)

    @staticmethod
    def backward(ctx, grad_out):
        _build.refuse_double_backward(
            "K5 warp_bwd", "TOF's meta-training needs a kernel for the warp's second "
            "derivative in the flow (ROADMAP A.7).")
        x, flow = ctx.saved_tensors
        gx, gflow = warp_bwd(x, flow, grad_out, need_x=ctx.needs_input_grad[0])
        return gx, gflow if ctx.needs_input_grad[1] else None


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
