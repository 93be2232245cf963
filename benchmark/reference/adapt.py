"""Plain PyTorch reference of DynaVSR's test-time adaptation (the DynaVSR
paper, WACV 2021): the estimator turns the first K LR windows of a
clip into SLR windows, the VSR net takes k Adam steps on the Charbonnier
loss of (SLR window -> LR centre frame), and the adapted net super-resolves
the clip's windows.

Adam is written out (betas 0.9 / 0.999, eps 1e-8 outside the square root,
bias-corrected moments), and the Charbonnier loss is
mean(sqrt(d^2 + 1e-12)). Imports torch and the reference's nets only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import nets

Params = nets.Params


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    d = (pred - target).float()
    return torch.sqrt(d * d + eps).mean()


class Adam:
    """Adam over a dict of leaf tensors, updated out of place."""

    def __init__(self, params: Params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params: Params, grads: Params) -> Params:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            out[k] = (p - self.lr * upd).detach()
        return out


def adapt(p0: Params, slr: torch.Tensor, lr_center: torch.Tensor, arch: dict, steps: int,
          lr: float, q) -> Tuple[Params, List[float], Params]:
    """k Adam steps of the VSR net on (SLR windows (K, N, h, w, 3) -> LR
    centres (K, 4h', 4w', 3)). Returns the adapted tensors, the loss before
    each step, and the first step's gradients."""
    params = {k: v.detach().clone() for k, v in p0.items()}
    opt = Adam(params, lr)
    losses, first = [], None
    for _ in range(steps):
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        pred = nets.edvr_padded(leaves, slr, arch, q)[:, : lr_center.shape[1], : lr_center.shape[2]]
        loss = charbonnier(pred, lr_center)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        losses.append(float(loss.detach()))
        params = opt.step({k: v.detach() for k, v in leaves.items()}, grads)
    return params, losses, first


def serve_clip(p_vsr: Params, p_est: Params, lq: torch.Tensor, windows: torch.Tensor,
               frames: List[int], cfg: Dict, q) -> Dict:
    """The reference's answer for one clip: lq (T, h, w, 3) on the device,
    windows (T, N) the frame indices of each window, `frames` the centre
    frames to super-resolve. Returns the SLR windows, the losses, the
    adapted tensors, the first gradients and {frame: SR (4h, 4w, 3)}."""
    arch, ad = cfg["network_G"], cfg["adapt"]
    n_adapt = min(int(ad["n_windows"]), lq.shape[0])
    aw = lq[windows[:n_adapt]]
    with torch.no_grad():
        slr = nets.mfdn(p_est, aw, cfg["scale"], q)
    center = aw.shape[1] // 2
    adapted, losses, first = adapt(p_vsr, slr, aw[:, center], arch, int(ad["n_steps"]),
                                   float(ad["lr"]), q)
    sr = {}
    with torch.no_grad():
        for f in frames:
            sr[f] = nets.edvr_padded(adapted, lq[windows[f]][None], arch, q)[0]
    return {"slr": slr, "losses": losses, "adapted": adapted, "first_grads": first, "sr": sr}


def windows(t: int, n: int) -> torch.Tensor:
    """(t, n) frame indices of the n-frame window centred on each frame of
    a t-frame clip, mirrored at the clip's ends (reflection padding:
    index -i for i < 0, 2(t-1) - i past the end)."""
    i = torch.arange(t).view(t, 1) + torch.arange(n).view(1, n) - n // 2
    i = torch.where(i < 0, -i, i)
    return torch.where(i > t - 1, 2 * (t - 1) - i, i)
