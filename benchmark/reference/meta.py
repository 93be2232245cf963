"""Plain PyTorch reference of DynaVSR's meta-training step (Algorithm 1 of
the DynaVSR paper, WACV 2021) and of its degradation synthesis.

Synthesis: one Gaussian kernel a clip (13x13; isotropic with sigma ~
U(0.2, 4), or with probability 1/2 anisotropic with axis sigmas ~ U(0.2,
4) and a rotation ~ U(0, pi)), drawn from a generator in the order sigma,
axis sigmas, rotation, choice; LR = (HR * k) subsampled by 4 after
reflection padding of 6, and SLR = MFDN(LR) when an estimator is in the
loop. Meta step: one inner SGD step (alpha) on Charbonnier(EDVR(SLR), LR
centre), differentiated through (second order), then the Charbonnier loss
of the adapted net on (LR windows -> HR centre) and one Adam step (the
configuration's betas) on its gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.adapt import Adam, charbonnier


def kernels(gen: torch.Generator, batch: int, size: int = 13) -> torch.Tensor:
    dev = gen.device

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    s_iso = u(batch, lo=0.2, hi=4.0)
    s_xy = u(batch, 2, lo=0.2, hi=4.0)
    theta = u(batch, hi=math.pi)
    aniso = u(batch) < 0.5
    ax = torch.arange(size, dtype=torch.float32, device=dev) - (size - 1) / 2
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    iso = torch.exp(-(x * x + y * y) / (2 * s_iso.view(-1, 1, 1) ** 2))
    c, s = torch.cos(theta).view(-1, 1, 1), torch.sin(theta).view(-1, 1, 1)
    xr, yr = c * x + s * y, -s * x + c * y
    ani = torch.exp(-0.5 * ((xr / s_xy[:, 0].view(-1, 1, 1)) ** 2
                            + (yr / s_xy[:, 1].view(-1, 1, 1)) ** 2))
    iso = iso / iso.sum((-2, -1), keepdim=True)
    ani = ani / ani.sum((-2, -1), keepdim=True)
    return torch.where(aniso.view(-1, 1, 1), ani, iso)


def blur_down(x: torch.Tensor, k: torch.Tensor, scale: int) -> torch.Tensor:
    """x (B, T, H, W, 3), k (B, s, s): each clip's frames blurred by its
    kernel (reflection padding), subsampled at 0, s, 2s, ..."""
    b, t, h, w, c = x.shape
    r = k.shape[-1] // 2
    out = []
    for i in range(b):
        xi = F.pad(x[i].permute(0, 3, 1, 2).float(), (r, r, r, r), mode="reflect")
        wk = k[i].expand(c, 1, *k.shape[-2:])
        out.append(F.conv2d(xi, wk, stride=scale, groups=c).permute(0, 2, 3, 1))
    return torch.stack(out)


def synthesize(gen: torch.Generator, hr: torch.Tensor, scale: int, p_est, q) -> Dict:
    lr = blur_down(hr, kernels(gen, hr.shape[0]), scale)
    with torch.no_grad():
        slr = nets.mfdn(p_est, lr, scale, q)
    c = hr.shape[1] // 2
    return {"SLR": slr, "LR": lr, "LR_center": lr[:, c], "HR_center": hr[:, c]}


def meta_grads(p, batch, arch: dict, alpha: float, q) -> Tuple[float, float, Dict]:
    """(outer loss, inner loss, meta gradient) of one second-order step."""
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    names = list(leaves)
    inner = charbonnier(nets.edvr_padded(leaves, batch["SLR"], arch, q), batch["LR_center"])
    g = torch.autograd.grad(inner, [leaves[k] for k in names], create_graph=True)
    fast = {k: leaves[k] - alpha * gk for k, gk in zip(names, g)}
    outer = charbonnier(nets.edvr_padded(fast, batch["LR"], arch, q), batch["HR_center"])
    grads = torch.autograd.grad(outer, [leaves[k] for k in names])
    return float(outer.detach()), float(inner.detach()), dict(zip(names, grads))


def train(p0, batches, arch: dict, meta: dict, q) -> Dict:
    """The reference's first steps from p0 on the given batches: each
    step's losses, the first meta gradient, the weights after them."""
    opt = Adam(p0, meta["lr_G"], (meta["beta1"], meta["beta2"]))
    p, out = {k: v.detach().clone() for k, v in p0.items()}, {"outer": [], "inner": []}
    for i, batch in enumerate(batches):
        outer, inner, grads = meta_grads(p, batch, arch, meta["maml_lr_alpha"], q)
        out["outer"].append(outer)
        out["inner"].append(inner)
        if i == 0:
            out["first_grads"] = {k: g.detach() for k, g in grads.items()}
        p = opt.step(p, grads)
    out["params"] = p
    return out
