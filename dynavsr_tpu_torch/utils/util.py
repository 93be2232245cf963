"""Experiment utilities — copy of dynavsr_tpu/utils/util.py (get_timestamp,
mkdirs, mkdir_and_rename, set_random_seed, setup_logger, ProgressBar).

set_random_seed also seeds torch: the port's networks draw their initial
weights from torch's generator (the JAX package from PRNGKey(manual_seed)).
The JAX package's enable_compilation_cache (XLA's persistent compile cache)
has no counterpart: the port compiles only its CUDA kernels, and their
build cache under build/ (ops/_build.py) keeps them across processes.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
import random
import shutil
import sys
import time
from datetime import datetime

import numpy as np
import torch

__all__ = ["get_timestamp", "mkdirs", "mkdir_and_rename", "set_random_seed", "setup_logger",
           "ProgressBar"]


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


class ProgressBar:
    """Terminal progress bar (the reference's utils/util.py:ProgressBar)."""

    def __init__(self, task_num: int = 0, bar_width: int = 50, start: bool = True):
        self.task_num = task_num
        self.bar_width = bar_width
        self.completed = 0
        if start:
            self.start()

    def start(self) -> None:
        if self.task_num > 0:
            sys.stdout.write(f"[{' ' * self.bar_width}] 0/{self.task_num}, elapsed: 0s, ETA:\n")
        else:
            sys.stdout.write("completed: 0, elapsed: 0s")
        sys.stdout.flush()
        self.start_time = time.time()

    def update(self, msg: str = "In progress...") -> None:
        self.completed += 1
        elapsed = time.time() - self.start_time
        fps = self.completed / max(elapsed, 1e-9)
        if self.task_num > 0:
            percentage = self.completed / float(self.task_num)
            eta = int(elapsed * (1 - percentage) / max(percentage, 1e-9) + 0.5)
            mark_width = int(self.bar_width * percentage)
            bar_chars = ">" * mark_width + " " * (self.bar_width - mark_width)
            sys.stdout.write(
                f"\033[2F\033[J[{bar_chars}] {self.completed}/{self.task_num}, "
                f"{fps:.1f} task/s, elapsed: {int(elapsed + 0.5)}s, "
                f"ETA: {eta:5}s\n{msg}\n")
        else:
            sys.stdout.write(f"completed: {self.completed}, elapsed: {int(elapsed + 0.5)}s, "
                             f"{fps:.1f} tasks/s")
        sys.stdout.flush()
