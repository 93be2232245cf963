"""Observability (port of dynavsr_tpu/utils/observability.py).

* MetricsWriter: every scalar goes to `<log_dir>/metrics.jsonl` (one JSON
  object a step, appended), and to TensorBoard event files when
  torch.utils.tensorboard imports (it needs the tensorboard package).
* StepTimer: wall-clock step time, its EMA, and throughput.
* profile_trace: a torch.profiler trace around a block (CPU activity, and
  CUDA on a card), written as a Chrome trace into `log_dir` by
  tensorboard_trace_handler (TensorBoard's profile tab, Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import torch

__all__ = ["MetricsWriter", "StepTimer", "profile_trace"]


class MetricsWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(osp.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(log_dir)

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": int(step), "ts": time.time(), **{k: float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class StepTimer:
    """EMA step-time / throughput meter (items = frames or samples)."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg = dt if self.avg is None else self.ema * self.avg + (1 - self.ema) * dt
        return dt

    def throughput(self, items: int) -> float:
        return items / self.avg if self.avg else 0.0


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """torch.profiler over the block, its trace written into log_dir when
    the block ends; yields the profiler (key_averages(), events()), or None
    when `enabled` is false, which profiles and writes nothing."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
