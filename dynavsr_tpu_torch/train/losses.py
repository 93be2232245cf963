"""Charbonnier loss (port of dynavsr_tpu/train/losses.py:charbonnier_loss)."""

from __future__ import annotations

import torch

__all__ = ["charbonnier_loss"]


def charbonnier_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12,
                     reduction: str = "sum") -> torch.Tensor:
    """sum (or mean) of sqrt((pred - target)^2 + eps), in fp32.
    The adaptation config uses reduction='mean' (AdaptConfig.reduction)."""
    d = (pred - target).to(torch.float32)
    val = torch.sqrt(d * d + eps)
    if reduction == "sum":
        return val.sum()
    if reduction == "mean":
        return val.mean()
    raise ValueError(f"unknown reduction {reduction!r}")
