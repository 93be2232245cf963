"""The program's own spans and counters in a traced window.

While torch.profiler records, the port (dynavsr_tpu_torch/utils/
observability.py) annotates its work as host events `span:<name>` and each
counter increment as a host event `count:<name>:<n>`, on the clock of the
device events. A reader takes them from the window's `Trace` alone:

- spans(trace, name): the (start, end) host intervals (us) of a span;
- idle_us(trace, intervals): the device idle inside intervals, their
  merged length less the union of the device events clipped to them;
- counter(trace, name): a counter's total over the window;
- idle_ms_per_unit(trace, *names): idle_us inside the named spans, in ms
  a unit of the window (the units the traced window ran, `units`);
- idle_by_span(trace) and longest_gaps_by_span(trace): each idle
  microsecond of the window given to the innermost program span the host
  was in, over the window and in its longest gaps.

On a program without such annotations spans gives [], counter 0 and
idle_ms_per_unit None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from benchmark.trace import Event, Trace, union_us

Interval = Tuple[float, float]

OUTSIDE = "outside"  # idle while the host was in no program span


def _merged(intervals) -> List[Interval]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def spans(trace: Trace, name: str) -> List[Interval]:
    """The (start, end) host intervals (us) of the program span `name`."""
    key = "span:" + name
    return [(e.start_us, e.end_us) for e in trace.host if e.name == key]


def idle_us(trace: Trace, intervals) -> float:
    """Device idle (us) inside the union of `intervals`: its length less
    the union of the device events clipped to it."""
    iv = _merged(intervals)
    ends = [b for _, b in iv]
    clipped = []
    for e in trace.device:
        j = bisect.bisect_right(ends, e.start_us)  # the first interval ending after e starts
        while j < len(iv) and iv[j][0] < e.end_us:
            clipped.append(Event(e.name, max(iv[j][0], e.start_us), min(iv[j][1], e.end_us)))
            j += 1
    return sum(b - a for a, b in iv) - union_us(clipped)


def counter(trace: Trace, name: str) -> float:
    """The sum of the window's increments of the counter `name`."""
    key = "count:" + name + ":"
    return sum(float(e.name[len(key):]) for e in trace.host if e.name.startswith(key))


def idle_ms_per_unit(trace: Trace, *names: str):
    """Device idle (ms) a unit inside the union of the program spans
    `names`; None where the window holds none of them."""
    n = trace.counters.get("units", 0)
    iv = [i for name in names for i in spans(trace, name)]
    return idle_us(trace, iv) / 1e3 / n if n and iv else None


def _innermost(trace: Trace, t0: float, t1: float) -> List[Tuple[float, float, str]]:
    """[t0, t1] cut into pieces (start, end, name), each named by the
    innermost program span that covers it (the last to start), or OUTSIDE.
    The benchmark's own spans (those its Tracer kept in trace.spans) are
    not the program's."""
    own = set(trace.spans)
    marks = sorted(((e.start_us, -e.end_us, e.name[5:]) for e in trace.host
                    if e.name.startswith("span:") and e.name[5:] not in own))
    pieces, stack, at = [], [], t0

    def upto(t):
        nonlocal at
        if t > at:
            pieces.append((at, t, stack[-1][1] if stack else OUTSIDE))
            at = t

    for a, neg_b, name in marks:
        while stack and stack[-1][0] <= a:  # the innermost ends: name its last piece
            upto(stack[-1][0])
            stack.pop()
        upto(a)
        stack.append((-neg_b, name))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(t1)
    return pieces


def _gaps_by_span(trace: Trace) -> List[Tuple[float, Dict[str, float]]]:
    """Every idle interval of the window (no device event; the window
    reaching from the first event, host or device, to the last) as
    (length us, {innermost program span: us})."""
    events = trace.host + trace.device
    if not events:
        return []
    t0 = min(e.start_us for e in events)
    t1 = max(e.end_us for e in events)
    idle, end = [], t0
    for e in sorted(trace.device, key=lambda e: e.start_us):
        if e.start_us > end:
            idle.append((end, e.start_us))
        end = max(end, e.end_us)
    if t1 > end:
        idle.append((end, t1))
    pieces = _innermost(trace, t0, t1)
    out, i = [], 0
    for a, b in idle:
        while pieces[i][1] <= a:
            i += 1
        cut: Dict[str, float] = {}
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            p, q, name = pieces[j]
            cut[name] = cut.get(name, 0.0) + min(b, q) - max(a, p)
            j += 1
        out.append((b - a, cut))
    return out


def idle_by_span(trace: Trace) -> Dict[str, float]:
    """The window's device idle (us) by the innermost program span the
    host was in (OUTSIDE for none), the largest first."""
    by: Dict[str, float] = {}
    for _, cut in _gaps_by_span(trace):
        for name, us in cut.items():
            by[name] = by.get(name, 0.0) + us
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def longest_gaps_by_span(trace: Trace, top: int = 10) -> List[Tuple[float, Dict[str, float]]]:
    """The `top` longest idle intervals, each as (us, {innermost program
    span: us}), the longest first."""
    return sorted(_gaps_by_span(trace), key=lambda g: -g[0])[:top]
