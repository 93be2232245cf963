"""Per-architecture input conventions: mod-padding for pyramid networks and
TOF's bicubic pre-upscale (port of dynavsr_tpu/models/padding.py).

EDVR needs H, W % 4 == 0 (three pyramid levels with exact x2 upsampling);
SpyNet/TOF needs % 8 on its pre-upscaled input; DUF (and any other
architecture) takes raw LR of any size, unpadded (`arch_mod` 1). The adaptation
pseudo-task's SLR windows (LR / 4, e.g. 36x44 or 9x11) are generally not
divisible. `mod_pad_apply` reflection-pads the bottom/right edges, applies,
and crops the scaled output back.

`make_model_apply` (eval mode) and `make_mutable_model_apply` (train mode:
BatchNorm takes batch statistics and moves its running statistics in
place) are built by one function, so the two forwards cannot drift apart.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from dynavsr_tpu_torch.data.resize import imresize

__all__ = ["arch_mod", "tof_raw_mod", "mod_pad", "mod_pad_apply", "make_model_apply",
           "make_mutable_model_apply"]


def arch_mod(which: Optional[str]) -> int:
    """Spatial divisibility an architecture needs of its network input."""
    if which == "EDVR":
        return 4
    if which == "TOF":
        return 8  # 4-level SpyNet on the pre-upscaled input
    return 1


def tof_raw_mod(scale: int) -> int:
    """Divisibility a raw-LR input needs so that its x`scale` pre-upscaled
    frames divide SpyNet's /8 pyramid: H*scale % 8 == 0 iff
    H % (8 // gcd(8, scale)) == 0."""
    return 8 // math.gcd(8, int(scale))


def mod_pad(x: torch.Tensor, mod: int) -> torch.Tensor:
    """Reflect-pad the H, W axes (-3, -2) of a (..., H, W, C) tensor up to
    multiples of `mod` (bottom/right only)."""
    h, w, c = x.shape[-3:]
    ph, pw = (-h) % mod, (-w) % mod
    if ph == 0 and pw == 0:
        return x
    flat = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    flat = F.pad(flat, (0, pw, 0, ph), mode="reflect")
    return flat.permute(0, 2, 3, 1).reshape(*x.shape[:-3], h + ph, w + pw, c)


def mod_pad_apply(apply: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                  mod: int, scale: int) -> torch.Tensor:
    """apply() over x with H/W reflection-padded to multiples of `mod`;
    output cropped to (H*scale, W*scale). x: (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    out = apply(mod_pad(x, mod))
    return out[..., : h * scale, : w * scale, :]


def _make_padded_apply(which: Optional[str], scale: int, train: bool) -> Callable:
    """The one place that encodes the per-architecture input conventions:
    TOF's MATLAB-bicubic pre-upscale (unless the module folds it in,
    TOFlow.pre_upscale) followed by mod-8 padding at scale 1, else
    mod-padding of the raw input. `train` puts the module in train mode for
    the call, eval mode otherwise."""

    def call(model, x):
        model.train(train)
        return model(x)

    def apply(model, x):
        if which == "TOF" and not getattr(model, "pre_upscale", False):
            b, n, h, w, c = x.shape
            up = imresize(x.reshape(b * n, h, w, c), float(scale))
            up = up.reshape(b, n, h * scale, w * scale, c)
            return mod_pad_apply(lambda v: call(model, v), up, mod=arch_mod("TOF"), scale=1)
        mod = tof_raw_mod(scale) if which == "TOF" else arch_mod(which)
        return mod_pad_apply(lambda v: call(model, v), x, mod=mod, scale=scale)

    return apply


def make_model_apply(which: Optional[str], scale: int) -> Callable:
    """(model, raw-LR windows) -> SR with the architecture's input
    convention, the module in eval mode (EDVR: mod-4 padding; TOF: bicubic
    pre-upscale, then mod-8 padding; DUF: none)."""
    return _make_padded_apply(which, scale, train=False)


def make_mutable_model_apply(which: Optional[str], scale: int) -> Callable:
    """Train-mode variant of make_model_apply for BatchNorm nets (TOF, DUF): the
    module runs in train mode, so BatchNorm normalises with batch
    statistics and EMA-updates its running statistics in place (the JAX
    version returns the updated batch_stats instead). The same input
    conventions as make_model_apply, by construction."""
    return _make_padded_apply(which, scale, train=True)
