"""YAML config — copy of dynavsr_tpu/config/options.py.

`parse(path, is_train)` (and `derive`, the same on a dict) propagates
`scale` into every dataset block, expands `dataroot_*` paths and flags
`.lmdb` roots as data_type 'lmdb',
expands the model and resume paths, derives `results_root` (test) or the
`experiments/<name>/{models,training_state,val_images}` tree (train, with
the `debug` overrides), and wraps the result in NoneDict so missing keys
read as None. PyYAML is imported inside `parse`, so the package imports on
a host without it.
"""

from __future__ import annotations

import os
import os.path as osp
from collections import OrderedDict
from typing import Any, Mapping, Optional

__all__ = ["parse", "derive", "dict_to_nonedict", "dict2str", "check_resume", "NoneDict"]


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


def parse(opt_path: str, is_train: bool = False, root: Optional[str] = None) -> NoneDict:
    """Load a YAML into a derived NoneDict config (see `derive`)."""
    with open(opt_path) as f:
        return derive(_ordered_load(f), is_train, root)


def derive(opt: dict, is_train: bool = False, root: Optional[str] = None) -> NoneDict:
    """`parse` without the YAML: derive a config dict (as the YAML loads)
    in place and return it as a NoneDict. root: the experiment tree's root
    (default: path.root, else the working directory)."""
    opt["is_train"] = is_train
    scale = opt.get("scale", 4)
    for phase_key, dataset in (opt.get("datasets") or {}).items():
        dataset["phase"] = phase_key.split("_")[0]
        dataset["scale"] = scale
        for k in list(dataset):
            if k.startswith("dataroot_") and dataset[k] is not None:
                dataset[k] = osp.expanduser(dataset[k])
                if dataset[k].endswith(".lmdb"):
                    dataset["data_type"] = "lmdb"
        dataset.setdefault("data_type", "img")
    if opt.get("network_G") is not None:
        opt["network_G"].setdefault("scale", scale)

    opt.setdefault("path", OrderedDict())
    for k, v in list(opt["path"].items()):
        if v is not None and ("pretrain_model" in k or "resume" in k or "root" in k):
            opt["path"][k] = osp.expanduser(str(v))
    base_root = root or opt["path"].get("root") or os.getcwd()
    opt["path"]["root"] = base_root
    name = opt.get("name", "unnamed")
    if is_train:
        experiments_root = osp.join(base_root, "experiments", name)
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if (opt.get("train") or {}).get("debug") or "debug" in name:
            t = opt.setdefault("train", OrderedDict())
            t["val_freq"] = 8
            opt.setdefault("logger", OrderedDict())["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        opt["path"]["results_root"] = osp.join(base_root, "results", name)
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


def check_resume(opt: Mapping, resume_iter: int) -> None:
    """With path.resume_state set, point path.pretrain_model_G at the
    network saved at the resumed iteration, <models>/<iter>_G.pth (the
    port's save_network file; the JAX package's is an orbax directory)."""
    if opt["path"].get("resume_state"):
        opt["path"]["pretrain_model_G"] = osp.join(opt["path"]["models"], f"{resume_iter}_G.pth")
