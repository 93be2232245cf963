"""The traced run: spans from the benchmark's own wrappers around the
program's entry points, the shapes of its DCN kernel launches, and the
device's events from torch.profiler. Per-layer metric readers
(benchmark/metrics/<name>.py) read the `Trace` this leaves behind.

Spans synchronise the device at both ends, so a span is the device's time
for its work too; they exist only in the traced run. The device events are
read from the profile's Kineto results (the arithmetic of
dynavsr_tpu_torch/utils/observability.py's device_events and busy_us,
frozen here)."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch


class Event(NamedTuple):
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


def union_us(events) -> float:
    """The length of the union of the events' spans (us)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.start_us, e.end_us) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


@dataclasses.dataclass
class Trace:
    """What one traced window left: its length, the device's events and
    the host's (CPU ops and span annotations), the spans by name
    ((start, end) host seconds), counters, the DCN launches as (kernel,
    (B, C, H, W), Gd, dtype), and what the driver adds (`info`: the
    configuration's dtype, FLOPs a unit, ...)."""
    window_s: float = 0.0
    device: List[Event] = dataclasses.field(default_factory=list)
    host: List[Event] = dataclasses.field(default_factory=list)
    spans: Dict[str, List[Tuple[float, float]]] = dataclasses.field(default_factory=dict)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    dcn_calls: List[tuple] = dataclasses.field(default_factory=list)
    info: dict = dataclasses.field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        return union_us(self.device) / 1e6

    def span_s(self, name: str) -> List[float]:
        return [b - a for a, b in self.spans.get(name, ())]


class Tracer:
    """Records spans and DCN launches while `active`; `window()` profiles
    the block and fills `trace`."""

    def __init__(self, sync: bool):
        self.trace = Trace()
        self.active = False
        self._sync = sync
        self._patches: List[tuple] = []

    def _now(self) -> float:
        if self._sync:
            torch.cuda.synchronize()
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        t0 = self._now()
        with torch.profiler.record_function("span:" + name):
            yield
        self.trace.spans.setdefault(name, []).append((t0, self._now()))

    def count(self, name: str, n: float = 1) -> None:
        if self.active:
            self.trace.counters[name] = self.trace.counters.get(name, 0) + n

    def patch(self, module, attr: str, value) -> None:
        """module.attr = value until restore()."""
        self._patches.append((module, attr, getattr(module, attr)))
        setattr(module, attr, value)

    def wrap(self, module, attr: str, span: str) -> None:
        """module.attr, a function, timed as `span` while active."""
        fn = getattr(module, attr)

        @functools.wraps(fn)
        def timed(*a, **k):
            with self.span(span):
                return fn(*a, **k)

        self.patch(module, attr, timed)

    def wrap_factory(self, module, attr: str, span: str) -> None:
        """module.attr builds a function: each function it builds is timed
        as `span` while active."""
        make = getattr(module, attr)

        @functools.wraps(make)
        def factory(*a, **k):
            fn = make(*a, **k)

            def timed(*b, **kw):
                with self.span(span):
                    return fn(*b, **kw)
            return timed

        self.patch(module, attr, factory)

    def record_dcn(self, dcn_module) -> None:
        """Each launch of the DCN kernels' Python launchers, recorded as
        (kernel, x's shape, Gd, dtype) while active."""
        names = {"_fwd": "dcn_fwd", "dcn_bwd_data": "dcn_bwd_data",
                 "dcn_bwd_weight": "dcn_bwd_weight", "dcn_fwd_tangent": "dcn_fwd_tangent",
                 "dcn_bwd_weight_tangent": "dcn_bwd_weight_tangent",
                 "dcn_bwd_data_tangent": "dcn_bwd_data_tangent"}
        for attr, kernel in names.items():
            fn = getattr(dcn_module, attr)

            def rec(*a, _fn=fn, _k=kernel, **k):
                if self.active:
                    gd = k.get("deformable_groups", a[-1] if isinstance(a[-1], int) else None)
                    self.trace.dcn_calls.append((_k, tuple(a[0].shape), gd, a[0].dtype))
                return _fn(*a, **k)

            self.patch(dcn_module, attr, rec)

    def restore(self) -> None:
        for module, attr, fn in reversed(self._patches):
            setattr(module, attr, fn)
        self._patches.clear()

    @contextlib.contextmanager
    def window(self):
        """Profile the block (CPU and, on a card, CUDA activity) and keep
        its events and length."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._sync else [])
        with profile(activities=acts) as prof:
            self.active = True
            t0 = self._now()
            try:
                yield self.trace
            finally:
                self.trace.window_s = self._now() - t0
                self.active = False
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.duration_ns() <= 0:
                continue
            ev = Event(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    self.trace.device.append(ev)
            else:
                self.trace.host.append(ev)


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """The longest gaps between device events, each named by the span the
    host was in and the host op that overlapped it most (or, where no op
    covers half of the gap, "no torch op"): [[name, s], ...]."""
    dev = sorted(trace.device, key=lambda e: e.start_us)
    gaps, end = [], None
    for e in dev:
        if end is not None and e.start_us > end:
            gaps.append((end, e.start_us))
        end = e.end_us if end is None else max(end, e.end_us)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        span, op, best = "window", "idle", 0.0
        for h in trace.host:
            ov = min(b, h.end_us) - max(a, h.start_us)
            if ov <= 0:
                continue
            if h.name.startswith("span:"):
                if h.start_us <= a and h.end_us >= b:
                    span = h.name[5:]
            elif ov > best:
                op, best = h.name, ov
        if best < 0.5 * (b - a):  # mostly Python or library work outside torch's ops
            op = f"no torch op ({op} {100 * best / (b - a):.0f}%)"
        out.append([f"{span}: {op}", (b - a) / 1e6])
    return out


def device_ops(trace: Trace, label: Callable[[str], str], top: int = 10) -> List[list]:
    """Device seconds by kernel label, the largest first."""
    by: Dict[str, float] = {}
    for e in trace.device:
        k = label(e.name)
        by[k] = by.get(k, 0.0) + e.us / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def label_seconds(trace: Trace, label: Callable[[str], str], *labels: str) -> float:
    return sum(e.us for e in trace.device if label(e.name) in labels) / 1e6

