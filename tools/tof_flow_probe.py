"""How far a trained TOFlow's SpyNet moves its samples, on the quality
protocol's val clip, on the CPU.

A TOFlow checkpoint of the blind-adaptation protocol (the port's
`<run>/experiments/vsr_tof/models/600_G.pth`, or the JAX tool's orbax
`<run>/experiments/vsr_tof/models/600_G`, converted with
tools/orbax_to_pth.convert) runs in fp32 through the port's net, with the
protocol's network_G (pre-upscale, 5 frames), over every window of the
first val clip of a data tree the port's tool wrote (`<run>/data`, LMDB;
the JAX tool's PNG tree holds the same frames within one uint8 level).
With --lr-crop N the clip is cut to its top-left N x N LR pixels (and
the GT to 4N x 4N), the size of the protocol's training and meta crops
(LQ_size 16). For each SpyNet level (frame size) it reads the flows' mean
|value| in px
and the share of samples that land off the frame (the warp's zero
padding: no gradient reaches the flow there); then the gradient norm of an
L1 loss against the GT centre frames in SpyNet's blocks and in the fusion
convs. Prints one JSON line per checkpoint.

    python tools/tof_flow_probe.py --data /tmp/qsw_tof/torch/data \\
        /tmp/qsw_tof/torch/experiments/vsr_tof/models/600_G.pth \\
        /tmp/seeds/jax_tof_s0/experiments/vsr_tof/models/600_G
    python tools/tof_flow_probe.py --data /tmp/qsw_tof/torch/data --lr-crop 16 <ckpt>
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import os.path as osp
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

NET_G = {"which_model_G": "TOF", "pre_upscale": True, "nframes": 5, "dtype": "float32"}


def load_tof(ckpt: str) -> torch.nn.Module:
    """The port's fp32 TOFlow with the weights of a `.pth` or an orbax
    directory, on the CPU."""
    from dynavsr_tpu_torch.models.networks import define_G
    from dynavsr_tpu_torch.train.checkpoint import load_pretrained

    net = define_G({"scale": 4, "network_G": NET_G}, "cpu")
    if osp.isdir(ckpt):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "orbax_to_pth", osp.join(osp.dirname(osp.abspath(__file__)), "orbax_to_pth.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with tempfile.TemporaryDirectory() as tmp:
            pth = osp.join(tmp, "net.pth")
            mod.convert(ckpt, pth, expected=net.state_dict())
            load_pretrained(net, pth)
    else:
        load_pretrained(net, ckpt)
    return net


def probe(net: torch.nn.Module, lq: np.ndarray, gt: np.ndarray) -> dict:
    """Flows per SpyNet level and gradient norms of one L1 loss over the
    clip's windows (reflection padding, as the protocol's tests)."""
    from dynavsr_tpu_torch.data.windows import all_windows
    from dynavsr_tpu_torch.models import tof as tof_module
    from dynavsr_tpu_torch.models.padding import make_model_apply

    flows = collections.defaultdict(list)
    warp = tof_module.warp_nchw

    def recording(x, flow):
        h, w = flow.shape[-2:]
        f = flow.detach()
        gx = torch.arange(w, dtype=f.dtype)[None, :] + f[:, 0]
        gy = torch.arange(h, dtype=f.dtype)[:, None] + f[:, 1]
        off = (gx < 0) | (gx > w - 1) | (gy < 0) | (gy > h - 1)
        flows[f"{h}x{w}"].append((float(f.abs().mean()), float(off.float().mean())))
        return warp(x, flow)

    win = all_windows(lq.shape[0], NET_G["nframes"], "reflection")
    apply = make_model_apply("TOF", 4)
    tof_module.warp_nchw = recording
    try:
        net.zero_grad(set_to_none=True)
        sr = apply(net, torch.from_numpy(lq[win]))
        loss = (sr.float() - torch.from_numpy(gt)).abs().mean()
        loss.backward()
    finally:
        tof_module.warp_nchw = warp
    grads = collections.defaultdict(float)
    for name, p in net.named_parameters():
        part = ".".join(name.split(".")[:2]) if name.startswith("spynet") else "fusion"
        if p.grad is not None:
            grads[part] += float(p.grad.norm()) ** 2
    return {"l1": float(loss.detach()),
            "flows": {k: {"absmean_px": float(np.mean([a for a, _ in v])),
                          "off_frame_share": float(np.mean([o for _, o in v]))}
                      for k, v in sorted(flows.items(), key=lambda kv: int(kv[0].split("x")[0]))},
            "grad_norm": {k: v ** 0.5 for k, v in grads.items()}}


def main(argv=None) -> int:
    from dynavsr_tpu_torch.data.lmdb_dataset import LmdbClipIndex

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", required=True, help="a data tree of the port's tool (<run>/data)")
    ap.add_argument("--lr-crop", type=int, default=0,
                    help="cut the clip to its top-left N x N LR pixels (0: whole frames)")
    ap.add_argument("ckpts", nargs="+", help="TOF checkpoints: .pth files or orbax directories")
    args = ap.parse_args(argv)
    clips = {}
    for leg, scale in (("LQ_bic", 1), ("GT", 4)):
        index = LmdbClipIndex(os.path.join(args.data, "val", f"{leg}.lmdb"))
        clip = index.names[0]
        frames = np.stack([index.read_frame(k) for k in index.clips[clip]])
        n = args.lr_crop * scale
        clips[leg] = np.ascontiguousarray(frames[:, :n, :n]) if n else frames
    for ckpt in args.ckpts:
        print(json.dumps({"ckpt": ckpt, **probe(load_tof(ckpt), clips["LQ_bic"], clips["GT"])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
