"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. A host
without a card raises instead of falling back, so a run that meant to
measure the GPU can never silently measure the CPU.

The port's float32 is IEEE float32 on the card as on the CPU: resolving a
CUDA device turns TF32 off for cuDNN convs and matmuls (the MATLAB-bicubic
`imresize` needs full fp32 products, and the reference is held to fp32).
bfloat16 is the opt-in fast path (`network_G.dtype`).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` -> the current CUDA device. A cuda device raises if no card is
    present; otherwise it comes back with its index, and TF32 is off."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
