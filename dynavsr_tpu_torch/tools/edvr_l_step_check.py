"""EDVR-L step check on the port (counterpart of the repo's
tools/edvr_l_step_check.py, with its flags and defaults): one supervised
step and one second-order meta step at the reference's EDVR-L size (nf
128, 5 + 40 blocks, Gd 8, bf16; options/train/train_EDVR_L_*.yml) and its
per-device batch (global 32 over 8 GPUs = 4).

The supervised step (train/trainer.make_train_step, Adam at lr 4e-4
constant) takes 4 windows of 5 x 64x64 LQ to 256x256 GT. The meta step
(train/meta.make_meta_train_step: one inner SGD step at alpha 1e-5, second
order, a fresh Adam at lr 4e-4) starts from the supervised weights and takes
2 windows: SLR 8x8, LR 32x32, HR 128x128. Each step runs once to build and
warm up, then --repeats times on distinct inputs (three draws in turn); the
best time is kept. Inputs are uniform draws from seed 0 on the device.

    python -m dynavsr_tpu_torch.tools.edvr_l_step_check [--batch 4] [--meta-batch 2] [--repeats 3]
        [--device cpu]

Prints the parameter count, each step's loss and time, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Callable, List, Optional, Tuple

import torch
import torch.nn as nn

from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.ops import dcn
from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step, meta_variables
from dynavsr_tpu_torch.train.trainer import (
    TrainerConfig,
    make_optimizer,
    make_schedule,
    make_train_step,
)

__all__ = ["EDVR_L", "make_net", "supervised_batches", "meta_batches", "supervised_steps",
           "meta_steps", "build_parser", "run", "main"]

# options/train/train_EDVR_L_REDS.yml's network_G, in bf16.
EDVR_L = {"which_model_G": "EDVR", "nf": 128, "nframes": 5, "groups": 8, "front_RBs": 5,
          "back_RBs": 40, "dtype": "bf16"}
TRAIN = TrainerConfig(lr=4e-4, scheme="constant")
META = MetaConfig(inner_lr=1e-5, inner_steps=1)
DRAWS = 3  # distinct inputs the repeats take in turn


def make_net(net_g: dict, device, seed: int = 0) -> nn.Module:
    """define_G's net for `net_g` on `device`, its initial weights drawn
    from `seed`."""
    torch.manual_seed(seed)
    return define_G({"network_G": dict(net_g)}, device)


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device)


def supervised_batches(device, batch: int, lq: int = 64, n_frames: int = 5,
                       scale: int = 4) -> List[dict]:
    """The first batch (LQs (batch, N, lq, lq, 3), GT (batch, lq*s, lq*s, 3))
    and DRAWS more with the same GT and LQs drawn anew."""
    gen = torch.Generator(device=device).manual_seed(0)
    x = _uniform(gen, (batch, n_frames, lq, lq, 3), device)
    gt = _uniform(gen, (batch, lq * scale, lq * scale, 3), device)
    return [{"LQs": x, "GT": gt}] + [
        {"LQs": _uniform(gen, x.shape, device), "GT": gt} for _ in range(DRAWS)]


def meta_batches(device, batch: int, slr: int = 8, n_frames: int = 5,
                 scale: int = 4) -> List[dict]:
    """The first meta batch (SLR (batch, N, slr, slr, 3), LR at slr*s,
    LR_center, HR_center at slr*s^2) and DRAWS more with the LR windows
    drawn anew."""
    gen = torch.Generator(device=device).manual_seed(1)
    lr, hr = slr * scale, slr * scale * scale
    first = {"SLR": _uniform(gen, (batch, n_frames, slr, slr, 3), device),
             "LR": _uniform(gen, (batch, n_frames, lr, lr, 3), device),
             "LR_center": _uniform(gen, (batch, lr, lr, 3), device),
             "HR_center": _uniform(gen, (batch, hr, hr, 3), device)}
    return [first] + [dict(first, LR=_uniform(gen, first["LR"].shape, device))
                      for _ in range(DRAWS)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(step: Callable, batches: List[dict], repeats: int, loss: str,
                 device) -> dict:
    """step(batches[0], 0) once (build and warm-up), then `repeats` steps on
    batches[1 + i % DRAWS]; each step's loss, its host time with the card
    synchronised, and the DCN kernels' launches of the last step."""
    t0 = time.perf_counter()
    losses = [float(step(batches[0], 0)[loss])]
    first_s = time.perf_counter() - t0
    times = []
    for i in range(repeats):
        dcn.reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        losses.append(float(step(batches[1 + i % DRAWS], 1 + i)[loss]))
        times.append(time.perf_counter() - t0)
    return dict(first_s=first_s, losses=losses, times=times,
                best_s=min(times) if times else None,
                launches={k: v for k, v in dcn.launch_counts().items() if v})


def supervised_steps(net: nn.Module, batches: List[dict], repeats: int, device) -> dict:
    """TRAIN's supervised step on `net` (updated in place) over `batches`."""
    step = make_train_step(net, TRAIN, make_optimizer(TRAIN, net.parameters()))
    return _timed_steps(step, batches, repeats, "l_pix", device)


def meta_steps(net: nn.Module, batches: List[dict], repeats: int, device) -> dict:
    """META's second-order meta step on `net` (updated in place) with a
    fresh Adam over meta_variables(net), over `batches`."""
    opt = make_optimizer(TRAIN, list(meta_variables(net).values()))
    step = make_meta_train_step(net, META, opt, make_schedule(TRAIN))
    return _timed_steps(step, batches, repeats, "l_outer", device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--meta-batch", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a host without a card raises) or cpu")
    return ap


def run(args: argparse.Namespace, device: Optional[torch.device] = None,
        net_g: Optional[dict] = None, lq: int = 64, slr: int = 8) -> Tuple[dict, nn.Module]:
    """Both checks on `device` (default: resolve_device(args.device)) at
    EDVR_L (or `net_g`), LQ lq^2 and SLR slr^2. Returns (the JSON record,
    the net after both steps)."""
    device = resolve_device(args.device) if device is None else device
    net_g = net_g or EDVR_L
    t0 = time.perf_counter()
    net = make_net(net_g, device)
    n_params = sum(p.numel() for p in net.parameters())
    print(f"EDVR params: {n_params / 1e6:.2f} M (init {time.perf_counter() - t0:.1f}s)",
          flush=True)
    sup = supervised_steps(net, supervised_batches(device, args.batch, lq), args.repeats,
                           device)
    print(f"supervised step build+run: {sup['first_s']:.1f}s l_pix={sup['losses'][0]:.4f}",
          flush=True)
    if sup["best_s"]:
        print(f"supervised step (batch {args.batch}): {sup['best_s']:.3f}s = "
              f"{args.batch / sup['best_s']:.2f} samples/s/card", flush=True)
    meta = meta_steps(net, meta_batches(device, args.meta_batch, slr), args.repeats, device)
    print(f"meta step build+run: {meta['first_s']:.1f}s l_outer={meta['losses'][0]:.4f}",
          flush=True)
    if meta["best_s"]:
        print(f"meta step (batch {args.meta_batch}): {meta['best_s']:.3f}s", flush=True)
    finite = all(math.isfinite(v) for v in sup["losses"] + meta["losses"])
    print(f"EDVR-L step check {'OK' if finite else 'FAILED: a loss is not finite'}", flush=True)
    record = {"device": str(device), "params": n_params, "batch": args.batch,
              "meta_batch": args.meta_batch, "repeats": args.repeats,
              "supervised": sup, "meta": meta, "finite": finite}
    return record, net


def main(argv=None) -> int:
    """Run both checks, print the JSON line; 0 iff every loss is finite."""
    record, _ = run(build_parser().parse_args(argv))
    print(json.dumps(record))
    return 0 if record["finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
