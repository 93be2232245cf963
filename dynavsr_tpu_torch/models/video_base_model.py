"""Plain evaluation model (port of the eval half of
dynavsr_tpu/models/video_base_model.py:VideoBaseModel and create_model).

`VideoBaseModel(opt, device)` builds `network_G` with define_G on the card
(unless the caller asks for the CPU), loads `path.pretrain_model_G`
through train/checkpoint.load_pretrained (honouring `path.strict_load`),
and hands out the forwards evaluation needs: numpy windows in, numpy SR
out, no autograd. The training methods wait for the port's trainer
(ROADMAP A.3).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from dynavsr_tpu_torch.adapt.adaptation import seq_forward
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import arch_mod, make_model_apply
from dynavsr_tpu_torch.train.checkpoint import load_pretrained

__all__ = ["VideoBaseModel", "create_model"]


class VideoBaseModel:
    """The VSR net of a test config, in eval mode on `device`."""

    def __init__(self, opt: Mapping, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        ev = opt.get("eval") or {}
        if ev.get("tile"):
            raise NotImplementedError("eval.tile is not ported yet (ROADMAP A.6)")
        self.scale = opt.get("scale", 4)
        self.infer_chunk = int(ev.get("infer_chunk") or 8)
        self.netG = define_G(opt, self.device).eval()
        path = opt.get("path") or {}
        load_pretrained(self.netG, path.get("pretrain_model_G"),
                        strict=path.get("strict_load", True) is not False)

    def make_infer_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """(F, N, h, w, 3) windows -> (F, H, W, 3) SR, with the net's input
        convention (models/padding.make_model_apply: EDVR's mod-4 padding,
        TOF's bicubic pre-upscale)."""
        apply = make_model_apply(self.netG.arch, self.scale)

        def infer(windows: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(windows), device=self.device)
                return apply(self.netG, x).cpu().numpy()

        return infer

    def make_seq_infer_fn(self) -> Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]]:
        """Sequence-mode forward (eval.seq): (frames (T, h, w, 3), win (F, N))
        -> (F, H, W, 3), each frame's pyramid extracted once and shared by
        the windows that hold it, `eval.infer_chunk` windows fused at a
        time (exact against the window path). The frames are reflect-padded
        to a multiple of 4 once, as the window path pads each window. None
        for a net without a pyramid-split forward (TOF, DUF)."""
        if self.netG.arch != "EDVR":
            return None
        mod = arch_mod("EDVR")

        def infer(frames: np.ndarray, win: np.ndarray) -> np.ndarray:
            h, w = frames.shape[1:3]
            ph, pw = (-h) % mod, (-w) % mod
            if ph or pw:
                frames = np.pad(frames, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect")
            with torch.no_grad():
                self.netG.eval()
                sr = seq_forward(self.netG, torch.as_tensor(frames, device=self.device),
                                 torch.as_tensor(win, dtype=torch.long, device=self.device),
                                 self.infer_chunk)
            return sr[:, : h * self.scale, : w * self.scale].cpu().numpy()

        return infer


def create_model(opt: Mapping, device=None) -> VideoBaseModel:
    """`opt['model']` dispatch (default video_base)."""
    which = opt.get("model") or "video_base"
    if which in ("video_base", "VideoSR_base", "sr"):
        return VideoBaseModel(opt, device)
    if which in ("video_meta", "meta", "dynavsr", "downscaler", "estimator"):
        raise NotImplementedError(
            f"Model [{which}] trains; the port's trainers come with ROADMAP A.3-A.5")
    raise NotImplementedError(f"Model [{which}] not recognized.")
