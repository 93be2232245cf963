"""The benchmark's inputs, made from the run's seed on the device: the
networks' weights (one generator, one draw, cut into the tensors of a
reference spec) and the traffic's frames (moving sinusoids). Every seed
gets the same sizes; only the values differ."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import nets

# Streams of one run's seed: weights and traffic never share draws.
STREAMS = {"weights_vsr": 1, "weights_est": 2, "traffic": 3, "check": 4}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one stream of the run's seed."""
    return (int(seed) * 8 + STREAMS[stream]) % (2 ** 63)


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def _std(kind: str, shape) -> float:
    """The draw's standard deviation by init kind: fan-in scaled convs,
    residual-block convs at a tenth of He's, last layers at a tenth of
    LeCun's (the output stays near its bicubic or bilinear base), and small
    biases. Offset convs take LeCun's, which puts the DCN's offsets at a
    fraction of a pixel to a few pixels."""
    fan = math.prod(shape[1:]) if len(shape) > 1 else 1
    return {"conv": math.sqrt(1 / fan), "offset": math.sqrt(1 / fan),
            "relu": math.sqrt(2 / fan), "res": 0.1 * math.sqrt(2 / fan),
            "last": 0.1 * math.sqrt(1 / fan), "bias": 0.01}[kind]


def make_params(spec: nets.Spec, seed: int, stream: str, device) -> Dict[str, torch.Tensor]:
    """The tensors of `spec` as float32 on the device: one normal draw from
    the seed's stream, cut and scaled."""
    sizes = [math.prod(s) for _, s, _ in spec]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device), device=device)
    out = {}
    for (name, shape, kind), part in zip(spec, flat.split(sizes)):
        out[name] = (part * _std(kind, shape)).view(shape)
    return out


def sinusoids(gen: torch.Generator, frames: int, h: int, w: int, components: int = 6,
              freq: float = 6.0, speed: float = 0.05) -> torch.Tensor:
    """(frames, h, w, 3) float32 in (0, 1): a sum of `components` moving
    sinusoids (up to `freq` cycles a frame, drifting up to `speed` of a
    frame a step), squashed by tanh. Frozen from the arithmetic of
    chip_smoke.py's synthetic_clip, made at the size asked for directly."""
    dev = gen.device
    y = torch.arange(h, device=dev).view(1, h, 1, 1) / h
    x = torch.arange(w, device=dev).view(1, 1, w, 1) / w
    t = torch.arange(frames, device=dev).view(frames, 1, 1, 1)
    acc = torch.zeros(frames, h, w, 3, device=dev)
    scale = torch.tensor([freq, freq, speed, speed, 2 * math.pi], device=dev)
    for _ in range(components):
        fy, fx, vy, vx, ph = (torch.rand(5, generator=gen, device=dev) * scale).unbind()
        amp = torch.rand(3, generator=gen, device=dev) * 0.6 + 0.2
        acc += amp * torch.sin(2 * math.pi * (fy * (y + vy * t) + fx * (x + vx * t)) + ph)
    return 0.5 + 0.45 * torch.tanh(acc / 2)


def vsr_spec(cfg: dict) -> nets.Spec:
    a = cfg["network_G"]
    return nets.edvr_spec(a["nf"], a["nframes"], a["groups"], a["front_RBs"], a["back_RBs"])


def est_spec(cfg: dict) -> nets.Spec:
    return nets.mfdn_spec(cfg["network_E"]["nf"], cfg["network_G"]["nframes"])
