"""Pixel losses (port of dynavsr_tpu/train/losses.py): Charbonnier,
sqrt(d^2 + eps), and the l1 / l2 criteria that train.pixel_criterion
selects. Each computes in fp32."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["charbonnier_loss", "l1_loss", "l2_loss", "make_pixel_criterion"]


def _reduce(val: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "sum":
        return val.sum()
    if reduction == "mean":
        return val.mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12,
                     reduction: str = "sum") -> torch.Tensor:
    """sum (or mean) of sqrt((pred - target)^2 + eps), in fp32.
    The adaptation config uses reduction='mean' (AdaptConfig.reduction)."""
    d = (pred - target).to(torch.float32)
    return _reduce(torch.sqrt(d * d + eps), reduction)


def l1_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce((pred - target).to(torch.float32).abs(), reduction)


def l2_loss(pred: torch.Tensor, target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    d = (pred - target).to(torch.float32)
    return _reduce(d * d, reduction)


def make_pixel_criterion(name: str = "cb", reduction: str = "mean") -> Callable:
    """'cb' | 'l1' | 'l2' -> loss(pred, target)."""
    if name in ("cb", "charbonnier"):
        return lambda p, t: charbonnier_loss(p, t, reduction=reduction)
    if name == "l1":
        return lambda p, t: l1_loss(p, t, reduction)
    if name == "l2":
        return lambda p, t: l2_loss(p, t, reduction)
    raise ValueError(f"unknown pixel criterion {name!r}")
