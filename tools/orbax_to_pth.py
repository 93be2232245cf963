"""Convert a JAX package orbax network checkpoint into a `.pth` the PyTorch
port loads.

The JAX package saves networks as orbax directories (`<iter>_G`,
dynavsr_tpu/train/checkpoint.py:save_network): a flax params tree, or a
variables dict {params, batch_stats} for the BatchNorm nets (TOFlow, DUF).
The port reads only `.pth` state_dicts (dynavsr_tpu_torch/train/
checkpoint.py:load_pretrained), and imports no orbax or jax. This script
sits outside both packages because it needs both: it restores with
dynavsr_tpu.train.checkpoint.load_network, maps with
dynavsr_tpu_torch.convert.from_jax.jax_params_to_state_dict (HWIO -> OIHW,
DHWIO -> OIDHW, stacked residual blocks unrolled, BatchNorm statistics to
running_mean / running_var), and writes the state_dict with torch.save.
Given a config (-opt), the result is checked key by key and shape by shape
against the state_dict of the net the port builds from it. Optimizer
`.state` files are not converted (neither package resumes across
frameworks).

    python tools/orbax_to_pth.py experiments/EDVR_M/models/600000_G EDVR_M.pth \\
        -opt configs/test/test_EDVR_M_REDS4.yml
    python tools/orbax_to_pth.py experiments/MFDN/models/1000_G MFDN.pth \\
        -opt configs/test/test_DynaVSR_Vid4.yml --network E
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
from typing import Mapping, Optional

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

__all__ = ["convert", "expected_state_dict", "main"]


def expected_state_dict(opt_path: str, network: str = "G") -> dict:
    """The state_dict of the port's net for a config's network_G (or, with
    network 'E', its estimator network_E: MFDN / SFDN), built on the CPU."""
    from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator
    from dynavsr_tpu_torch.config.options import parse
    from dynavsr_tpu_torch.models.networks import define_G

    opt = parse(opt_path)
    if network == "E":
        net = build_estimator(opt["network_E"] or {}, opt.get("scale", 4),
                              (opt["network_G"] or {}).get("nframes", 5), device="cpu")
    else:
        net = define_G(opt, device="cpu")
    return net.state_dict()


def convert(ckpt: str, out: str, expected: Optional[Mapping[str, torch.Tensor]] = None) -> dict:
    """Restore the orbax checkpoint `ckpt`, map it to the port's keys
    (checked against `expected` when given) and torch.save it to `out`.
    Returns the state_dict written."""
    import jax

    from dynavsr_tpu.train.checkpoint import load_network
    from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict

    tree = jax.tree_util.tree_map(np.asarray, load_network(ckpt))
    state = jax_params_to_state_dict(tree, expected)
    torch.save(state, out)
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="the orbax directory (<iter>_<label>)")
    ap.add_argument("out", help="the .pth to write")
    ap.add_argument("-opt", default=None,
                    help="a config whose net the result must match (keys and shapes)")
    ap.add_argument("--network", choices=["G", "E"], default="G",
                    help="which of the config's nets: network_G, or the estimator network_E")
    args = ap.parse_args(argv)
    expected = expected_state_dict(args.opt, args.network) if args.opt else None
    state = convert(args.ckpt, args.out, expected)
    print(f"{args.ckpt} -> {args.out}: {len(state)} tensors"
          + (", matching the config's net" if expected is not None else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
