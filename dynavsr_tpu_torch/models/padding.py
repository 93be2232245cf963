"""Mod-padding for pyramid networks (port of dynavsr_tpu/models/padding.py,
EDVR only for now).

EDVR needs H, W % 4 == 0 (three pyramid levels with exact x2 upsampling);
the adaptation pseudo-task's SLR windows (LR / 4, e.g. 36x44 or 9x11) are
generally not. `mod_pad_apply` reflection-pads the bottom/right edges,
applies, and crops the scaled output back.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["arch_mod", "mod_pad", "mod_pad_apply", "make_model_apply"]


def arch_mod(which: str) -> int:
    """Spatial divisibility an architecture needs."""
    if which == "EDVR":
        return 4
    raise NotImplementedError(f"{which} is not ported yet (ROADMAP: TOF, DUF)")


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


def make_model_apply(which: Optional[str], scale: int) -> Callable:
    """(model, raw-LR windows) -> SR with the architecture's input
    convention (EDVR: mod-4 padding, so any SLR size goes through)."""
    mod = arch_mod(which)

    def apply(model, x):
        return mod_pad_apply(model, x, mod=mod, scale=scale)

    return apply
