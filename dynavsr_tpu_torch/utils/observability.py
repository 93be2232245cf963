"""Training metrics — copy of dynavsr_tpu/utils/observability.py:MetricsWriter.

Every scalar goes to `<log_dir>/metrics.jsonl` (one JSON object a step,
appended), and to TensorBoard event files when torch.utils.tensorboard
imports (it needs the tensorboard package).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict

__all__ = ["MetricsWriter"]


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
