"""YAML config — copy of dynavsr_tpu/config/options.py for test configs.

`parse(path)` propagates `scale` into every dataset block, expands
`dataroot_*` and model paths, derives `results_root`, and wraps the result
in NoneDict so missing keys read as None. PyYAML is imported inside
`parse`, so the package imports on a host without it.
"""

from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from typing import Any, Mapping

__all__ = ["parse", "dict_to_nonedict", "dict2str", "NoneDict"]


class NoneDict(dict):
    """dict returning None for missing keys."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt: Any) -> Any:
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, (list, tuple)):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def _ordered_load(stream) -> OrderedDict:
    import yaml

    class OrderedLoader(yaml.SafeLoader):
        pass

    def construct_mapping(loader, node):
        loader.flatten_mapping(node)
        return OrderedDict(loader.construct_pairs(node))

    OrderedLoader.add_constructor(
        yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, construct_mapping
    )
    return yaml.load(stream, OrderedLoader)


def parse(opt_path: str) -> NoneDict:
    """Load a test YAML into a derived NoneDict config (the test-time half
    of the JAX package's parse)."""
    with open(opt_path) as f:
        opt = _ordered_load(f)

    scale = opt.get("scale", 4)
    for phase_key, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase_key.split("_")[0]
        dataset["scale"] = scale
        for k in list(dataset):
            if k.startswith("dataroot_") and dataset[k] is not None:
                dataset[k] = osp.expanduser(dataset[k])
    if opt.get("network_G") is not None:
        opt["network_G"].setdefault("scale", scale)

    opt.setdefault("path", OrderedDict())
    for k, v in list(opt["path"].items()):
        if v is not None and ("pretrain_model" in k or "root" in k):
            opt["path"][k] = osp.expanduser(str(v))
    base_root = opt["path"].get("root") or os.getcwd()
    opt["path"]["root"] = base_root
    results_root = osp.join(base_root, "results", opt.get("name", "unnamed"))
    opt["path"]["results_root"] = results_root
    return dict_to_nonedict(opt)


def dict2str(opt: Mapping, indent_l: int = 1) -> str:
    """Pretty-print a nested config."""
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + f"{k}:[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + f"{k}: {v}\n"
    return msg
