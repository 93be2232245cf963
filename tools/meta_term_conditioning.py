"""How well conditioned the second-order meta term is under the meta loss's
Charbonnier eps: the premise of chip_smoke.py phase 11c's float64 gauge.

A TOFlow (7 frames, pre-upscale, random weights from --seed, BatchNorm
statistics moved off 0 / 1) on a smooth synthetic meta batch (SLR, LR,
LR_center, HR_center at LR --lr x --lr); for each of --draws draws of
SpyNet's last-conv biases N(0, chip_smoke.SPY_BIAS_STD) (11c's redraw) and
each Charbonnier eps (the configs' 1e-12 and chip_smoke.TERM_CB_EPS), at
the first alpha of chip_smoke.ALPHAS whose fp32 term is at least
chip_smoke.TERM_SHARE of the meta gradient, the relative distance from the
float64 term on the batch of

- `fp32`: the fp32 term on the batch,
- `fp32_moved`: the fp32 term on the batch with every value moved by one
  fp32 ulp (chip_smoke.JITTER, a fixed draw),
- `f64_moved`: the float64 term on that moved batch.

`f64_moved` is the term's own move under a one-ulp move of its input: where
it is large no fp32 evaluation, the kernels' or the plain op's, can be held
to the float64 term. Every warp runs the plain warp here (CPU tensors).
Prints one JSON line per draw and eps.

    python tools/meta_term_conditioning.py [--draws 4] [--lr 32] [--threads 4]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import types

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

EPS = (1e-12, 1e-4)


def smooth_batch(rng: np.random.Generator, lr: int, frames: int = 7) -> dict:
    """A meta batch of one window: smooth frames in [0, 1] (random values
    on a 1/4 grid, bilinearly upsampled), SLR at lr / 4 and HR at 4 lr."""

    def smooth(*shape):
        *lead, h, w, c = shape
        x = torch.from_numpy(rng.random((int(np.prod(lead or [1])), c, h // 4 + 1, w // 4 + 1),
                                        dtype=np.float32))
        x = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear",
                                            align_corners=False)
        return x.movedim(1, -1).reshape(*lead, h, w, c).contiguous()

    lr_frames = smooth(1, frames, lr, lr, 3)
    return {"SLR": smooth(1, frames, lr // 4, lr // 4, 3), "LR": lr_frames,
            "LR_center": lr_frames[:, frames // 2].contiguous(),
            "HR_center": smooth(1, 4 * lr, 4 * lr, 3)}


def tof_net(seed: int) -> torch.nn.Module:
    """The protocol's meta-trained TOFlow shape on the CPU: random weights
    from `seed`, running means moved by N(0, 0.01), running variances by
    |N(0, 0.01)| (meta-training moves them off torch's 0 / 1)."""
    from dynavsr_tpu_torch.models.networks import define_G

    torch.manual_seed(seed)
    net = define_G({"scale": 4, "network_G": {"which_model_G": "TOF", "nframes": 7,
                                              "pre_upscale": True}}, "cpu")
    with torch.no_grad():
        for name, b in net.named_buffers():
            if name.endswith("running_mean"):
                b.add_(0.01 * torch.randn_like(b))
            elif name.endswith("running_var"):
                b.add_(0.01 * torch.randn_like(b).abs())
    return net


def readings(net: torch.nn.Module, batch: dict, eps: float) -> dict:
    """The three distances of the module docstring at one eps."""
    import chip_smoke as cs

    def term(m, b, alpha):
        return cs.meta_gradient(m, b, alpha, False) - cs.meta_gradient(m, b, alpha, True)

    m = types.SimpleNamespace(netG=net)
    gen = torch.Generator().manual_seed(cs.SEED)
    moved = {k: v * (1 + cs.JITTER * torch.randn(v.shape, generator=gen, dtype=v.dtype))
             for k, v in batch.items()}
    with cs.meta_charbonnier(eps):
        for alpha in cs.ALPHAS:
            d = term(m, batch, alpha)
            share = float(d.norm() / cs.meta_gradient(m, batch, alpha, False).norm())
            if share >= cs.TERM_SHARE:
                break
        m64 = types.SimpleNamespace(netG=cs.float64_net(net))
        d64 = term(m64, {k: v.double() for k, v in batch.items()}, alpha)

        def dist(x):
            return float((x.double() - d64).norm() / d64.norm())

        return dict(eps=eps, alpha=alpha, share=share, fp32=dist(d),
                    fp32_moved=dist(term(m, moved, alpha)),
                    f64_moved=dist(term(m64, {k: v.double() for k, v in moved.items()}, alpha)))


def probe(draws: int, lr: int, seed: int = 0, eps=EPS):
    """Yields one reading (a dict) per bias draw and eps."""
    import chip_smoke as cs

    net = tof_net(seed)
    rng = np.random.default_rng(seed)
    batch = smooth_batch(rng, lr)
    gen = torch.Generator().manual_seed(seed)
    biases = [p for n, p in net.named_parameters()
              if n.startswith("spynet.block") and n.endswith("conv4.bias")]
    for draw in range(draws):
        with torch.no_grad():
            for p in biases:
                p.copy_(torch.randn(p.shape, generator=gen) * cs.SPY_BIAS_STD)
        for e in eps:
            yield dict(draw=draw, **readings(net, batch, e))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--lr", type=int, default=32, help="LR frame size (SLR is a quarter)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    for r in probe(args.draws, args.lr, args.seed):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
