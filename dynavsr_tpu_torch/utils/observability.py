"""Observability (port of dynavsr_tpu/utils/observability.py).

* MetricsWriter: every scalar goes to `<log_dir>/metrics.jsonl` (one JSON
  object a step, appended), and to TensorBoard event files when
  torch.utils.tensorboard imports (it needs the tensorboard package).
* span / count: the program's own spans and counters, on while
  torch.profiler records (and a single check otherwise). A span
  is a host annotation `span:<name>` in the profile, on the device
  events' clock; a count is an annotation `count:<name>:<n>` of its own,
  so a profile's counts are read from that profile alone.
* profile_trace: a torch.profiler trace around a block (CPU activity, and
  CUDA on a card), written as a Chrome trace into `log_dir` by
  tensorboard_trace_handler (TensorBoard's profile tab, Perfetto).
* device_events / busy_us: a finished profile's device events (kernels,
  copies, memsets) read from its Kineto results, and the length of their
  union.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import os.path as osp
import time
from typing import Dict, List, NamedTuple

import torch
from torch.profiler import record_function

__all__ = ["MetricsWriter", "span", "count", "profile_trace", "DeviceEvent", "device_events",
           "busy_us"]


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


# Whether torch.profiler records on this thread (a bool from C++).
_tracing = torch.autograd._profiler_enabled

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one piece of the program's work: while a
    profiler records, torch.profiler.record_function("span:" + name), a
    host annotation whose parent is the span that encloses it on this
    thread; otherwise one shared no-op. Neither synchronises the device:
    the device's time inside a span is read from the profile's device
    events."""
    if not _tracing():
        return _OFF
    return record_function("span:" + name)


def count(name: str, n) -> None:
    """Add n to the counter `name` while a profiler records, as an
    annotation `count:<name>:<n>` in its profile (of a duration above zero,
    as the annotation's own enter and exit take time); otherwise nothing."""
    if _tracing():
        with record_function(f"count:{name}:{n}"):
            pass


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


class DeviceEvent(NamedTuple):
    """One device event of a profile: its name and its span (us)."""
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


def device_events(prof) -> List[DeviceEvent]:
    """A finished torch.profiler run's device events with a duration
    (kernels, copies, memsets; no user annotation), read from its Kineto
    results: prof.events() builds the whole host-op tree first, which
    takes some 40x as long on a trace of many small operations."""
    cuda = torch.autograd.DeviceType.CUDA
    return [DeviceEvent(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and e.duration_ns() > 0 and not e.is_user_annotation()]


def busy_us(events) -> float:
    """The length of the union of the events' spans (us)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.start_us, e.end_us) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy
