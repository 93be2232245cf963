"""Experiment utilities — copy of dynavsr_tpu/utils/util.py (get_timestamp,
mkdirs, mkdir_and_rename, set_random_seed, setup_logger).

set_random_seed also seeds torch: the port's networks draw their initial
weights from torch's generator (the JAX package from PRNGKey(manual_seed)).
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import random
import shutil
from datetime import datetime

import numpy as np
import torch

__all__ = ["get_timestamp", "mkdirs", "mkdir_and_rename", "set_random_seed", "setup_logger"]


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdirs(paths) -> None:
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        os.makedirs(p, exist_ok=True)


def mkdir_and_rename(path: str) -> None:
    """If path exists, archive it as <path>_archived_<timestamp>, then make
    it anew."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        logging.getLogger("base").info("Path already exists. Rename it to %s", new_name)
        shutil.move(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_logger(logger_name: str, root: str, phase: str, level: int = logging.INFO,
                 screen: bool = False, tofile: bool = True) -> logging.Logger:
    """File (<root>/<phase>_<timestamp>.log) and console logger. Setting up
    a logger name again replaces its handlers (and closes the old ones), so
    entry points driven in-process more than once do not repeat lines or
    leak open files."""
    lg = logging.getLogger(logger_name)
    for h in list(lg.handlers):
        lg.removeHandler(h)
        h.close()
    formatter = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                                  datefmt="%y-%m-%d %H:%M:%S")
    lg.setLevel(level)
    lg.propagate = False
    if tofile:
        mkdirs(root)
        fh = logging.FileHandler(osp.join(root, f"{phase}_{get_timestamp()}.log"), mode="w")
        fh.setFormatter(formatter)
        lg.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        lg.addHandler(sh)
    return lg
