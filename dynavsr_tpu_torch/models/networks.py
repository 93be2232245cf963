"""Network factory (port of dynavsr_tpu/models/networks.py:define_G).

String dispatch on `network_G.which_model_G` (EDVR, TOF, DUF_16L/28L/52L,
and the downscalers MFDN and SFDN), so the reference YAML
configs drive the port as they drive the JAX package. The module comes
back on `resolve_device(device)`: the card unless the caller asks for the
CPU.

`network_G.s2d_conv` is accepted and has no effect. In the JAX package it
picks a space-to-depth schedule for TOF's and DUF's stride-1 convs
(dynavsr_tpu/ops/conv_s2d.py: weights repacked so the TPU's matrix unit
gets more output lanes, the conv itself XLA's) whose output equals the
plain conv's; EDVR ignores it there too. On the card the port runs the
library convolution for every conv, so both settings build one network.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.models.downscaler import MFDN, SFDN
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.tof import TOFlow

__all__ = ["define_G"]

_DUF_DENSE1 = {"DUF_16L": 3, "DUF_28L": 9, "DUF_52L": 21}
_DTYPES = {None: None, "float32": None, "fp32": None,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _net_dtype(opt_net: Mapping[str, Any]) -> Optional[torch.dtype]:
    """network_G.dtype: 'bfloat16' runs the convs in bf16 (the parameters
    stay fp32); absent or 'float32' is fp32."""
    name = opt_net.get("dtype")
    if name not in _DTYPES:
        raise ValueError(f"unknown network dtype {name!r}")
    return _DTYPES[name]


def define_G(opt: Mapping[str, Any], device=None) -> torch.nn.Module:
    """opt: a full config dict; reads opt['network_G'] (and opt['scale'])."""
    device = resolve_device(device)
    opt_net = opt["network_G"]
    which = opt_net["which_model_G"]
    scale = opt.get("scale", 4)
    dt = _net_dtype(opt_net)
    if which == "EDVR":
        net = EDVR(
            nf=opt_net.get("nf", 64), nframes=opt_net.get("nframes", 5),
            groups=opt_net.get("groups", 8), front_RBs=opt_net.get("front_RBs", 5),
            back_RBs=opt_net.get("back_RBs", 10), center=opt_net.get("center"),
            predeblur=bool(opt_net.get("predeblur", False)),
            hr_in=bool(opt_net.get("HR_in", False)),
            w_TSA=opt_net.get("w_TSA", True) is not False, dtype=dt)
    elif which == "TOF":
        net = TOFlow(dtype=dt, pre_upscale=bool(opt_net.get("pre_upscale")), scale=scale,
                     nframes=opt_net.get("nframes", 7))
    elif which == "MFDN":
        net = MFDN(scale=scale, nf=opt_net.get("nf", 64), nframes=opt_net.get("nframes", 5),
                   dtype=dt)
    elif which == "SFDN":
        net = SFDN(scale=scale, nf=opt_net.get("nf", 64), dtype=dt)
    elif which in _DUF_DENSE1:
        net = DUF(scale=scale, dense1_layers=_DUF_DENSE1[which], dtype=dt)
    else:
        raise NotImplementedError(f"Generator model [{which}] not recognized")
    return net.to(device)
