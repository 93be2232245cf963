"""JAX (flax) params -> torch state_dict, the inverse of
dynavsr_tpu/convert/torch_import.py:convert_state_dict.

The port keeps the reference's attribute names, so the mapping is
mechanical:

  flax path                                   torch key
  conv_first/kernel (HWIO)                 -> conv_first.weight (OIHW)
  pcd_align/L1_dcnpack/weight (HWIO)       -> pcd_align.L1_dcnpack.weight (OIHW)
  feature_extraction/blocks/block/conv1/kernel, stacked on axis 0
                                           -> feature_extraction.{i}.conv1.weight

A reference `.pth` needs no conversion: strip the `module.` prefix and
`load_state_dict` it.
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
    return torch.tensor(a, dtype=torch.float32)


def jax_params_to_state_dict(params: Mapping,
                             expected: Optional[Mapping[str, torch.Tensor]] = None
                             ) -> Dict[str, torch.Tensor]:
    """params: nested dict of numpy arrays (optionally under 'params').

    With `expected` (a module's state_dict), raise KeyError on a key missing
    from either side and ValueError on a shape mismatch."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        *mods, name = path
        torch_leaf = "weight" if name == "kernel" else name
        if "blocks" in mods:
            i_b = mods.index("blocks")
            prefix, suffix = mods[:i_b], [m for m in mods[i_b + 1:] if m != "block"]
            for i, block in enumerate(np.asarray(leaf)):
                key = ".".join(prefix + [str(i)] + suffix + [torch_leaf])
                out[key] = _to_torch(block, name)
        else:
            out[".".join(mods + [torch_leaf])] = _to_torch(leaf, name)
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


def strip_module_prefix(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Drop DDP's 'module.' prefix from reference checkpoint keys."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}
