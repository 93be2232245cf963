"""JAX (flax) params -> torch state_dict, the inverse of
dynavsr_tpu/convert/torch_import.py:convert_state_dict.

The port keeps the reference's attribute names, so the mapping is
mechanical:

  flax path                                   torch key
  conv_first/kernel (HWIO)                 -> conv_first.weight (OIHW)
  dense1_0/conv2/kernel (DHWIO, 3-D conv)  -> dense1_0.conv2.weight (OIDHW)
  pcd_align/L1_dcnpack/weight (HWIO)       -> pcd_align.L1_dcnpack.weight (OIHW)
  feature_extraction/blocks/block/conv1/kernel, stacked on axis 0
                                           -> feature_extraction.{i}.conv1.weight
  pre_deblur/RB_L1_1/conv1/kernel          -> pre_deblur.RB_L1_1.conv1.weight
  tsa_fusion/kernel (EDVR w_TSA false)     -> tsa_fusion.weight (a 1x1 conv)
  body0/kernel, down/kernel (MFDN, SFDN)   -> body0.weight, down.weight
  spynet/block0/bn0/scale                  -> spynet.block0.bn0.weight
  batch_stats: spynet/block0/bn0/mean, var -> spynet.block0.bn0.running_mean,
                                              running_var (+ num_batches_tracked 0)

A reference `.pth` needs no conversion: strip the `module.` prefix and
`load_state_dict` it (train/checkpoint.load_pretrained).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["jax_params_to_state_dict", "strip_module_prefix"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _to_torch(arr: np.ndarray, leaf: str) -> torch.Tensor:
    a = np.asarray(arr)
    if leaf in ("kernel", "weight") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif leaf in ("kernel", "weight") and a.ndim == 5:
        a = a.transpose(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    return torch.tensor(a, dtype=torch.float32)


_PARAM_LEAF = {"kernel": "weight", "scale": "weight"}
_STATS_LEAF = {"mean": "running_mean", "var": "running_var"}


def jax_params_to_state_dict(params: Mapping,
                             expected: Optional[Mapping[str, torch.Tensor]] = None
                             ) -> Dict[str, torch.Tensor]:
    """params: nested dict of numpy arrays; either the params tree itself or
    a flax variables dict {'params': ..., 'batch_stats': ...}. BatchNorm
    statistics become running_mean / running_var, each with a
    num_batches_tracked of 0.

    With `expected` (a module's state_dict), raise KeyError on a key missing
    from either side and ValueError on a shape mismatch."""
    roots = {"params": params}
    if "params" in params and set(params) <= {"params", "batch_stats"}:
        roots = {k: params[k] for k in params}
    out: Dict[str, torch.Tensor] = {}
    for root, tree in roots.items():
        _convert(tree, _STATS_LEAF if root == "batch_stats" else _PARAM_LEAF, out)
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        extra = sorted(set(out) - set(expected))
        if missing or extra:
            raise KeyError(f"params do not match the model: missing {missing}, "
                           f"unexpected {extra}")
        for k, v in out.items():
            if tuple(v.shape) != tuple(expected[k].shape):
                raise ValueError(f"{k}: converted shape {tuple(v.shape)}, model wants "
                                 f"{tuple(expected[k].shape)}")
    return out


def _convert(tree: Mapping, leaf_names: Mapping[str, str], out: Dict[str, torch.Tensor]):
    for path, leaf in _flatten(tree):
        *mods, name = path
        torch_leaf = leaf_names.get(name, name)
        if "blocks" in mods:
            i_b = mods.index("blocks")
            prefix, suffix = mods[:i_b], [m for m in mods[i_b + 1:] if m != "block"]
            items = [(prefix + [str(i)] + suffix, block)
                     for i, block in enumerate(np.asarray(leaf))]
        else:
            items = [(mods, leaf)]
        for module, value in items:
            out[".".join(module + [torch_leaf])] = _to_torch(value, name)
            if torch_leaf == "running_mean":
                out[".".join(module + ["num_batches_tracked"])] = torch.tensor(0)


def strip_module_prefix(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop DDP's 'module.' prefix from reference checkpoint keys."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}
