"""Op-level profiler on the port (counterpart of the repo's
tools/profile_ops.py, with its flags and defaults): one warmed call of a
workload under torch.profiler (utils/observability.profile_trace, which
also writes a Chrome trace), and its top operations by time; a workload
shorter than 20 ms is profiled over enough calls to span that, its table
read per call.

On a card the table is the device's time by label: each of the port's
kernels by its name (`dcn_fwd` ... `warp_bwd_tangent`, `duf_bwd`; the
helper kernels a wrapper launches beside its main one as `<name> helpers`),
cuDNN / cuBLAS kernels by family (conv fprop / dgrad / wgrad / fft, gemm),
and the rest by kind (elementwise, reduction, memcpy, memset, ...); `other`
holds what no rule names (`--dump N` prints the N longest raw kernel
names). On the CPU (`--device cpu`) it is the host operators' self time by
name. Workloads, at the JAX tool's shapes (bf16 nets, random weights from
seed 0):
  edvr_fwd     EDVR-M forward, 4 windows x 5 x 144x176            (K1)
  dcn          one DCN, 20 x 64 x 144x176                         (K1)
  tof          TOFlow forward, 4 windows x 7 x 576x704            (K4)
  duf          DUF-16L forward, 4 windows x 7 x 144x176           (K6)
  adapt_only   5 Adam steps on 8 SLR windows of 5 x 36x44         (K1-K3)
  stream_step  one steady StreamingSR push, 5 x 144x176           (K1)
  adapt        make_adapt_and_infer: 16 windows, 8 adapted, 5 steps (K1-K3)

    python -m dynavsr_tpu_torch.tools.profile_ops [--workload edvr_fwd] [--top 15] [--groups 8]
        [--dump N] [--device cpu]

Prints the table, the top rows' sum, the total and the profiled window,
then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_and_infer, make_adapt_fn
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.streaming import StreamingSR
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.ops import dcn, duf_filter
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.utils.observability import busy_us, device_events, profile_trace

__all__ = ["WORKLOADS", "kernel_label", "launch_label", "op_table", "make_workload",
           "profile_workload", "build_parser", "main"]

WORKLOADS = ("edvr_fwd", "dcn", "adapt", "adapt_only", "tof", "duf", "stream_step")

# Labels by a part of the kernel's name, first match wins: the port's
# kernels (csrc/*.cu; the tangents before the first-order names they
# extend), the helper kernels of their wrappers, then the library's
# families and kinds.
LABELS = (
    ("dcn_fwd_tangent_kernel", "dcn_fwd_tangent"),
    ("dcn_bwd_weight_tangent_kernel", "dcn_bwd_weight_tangent"),
    ("dcn_bwd_data_tangent_kernel", "dcn_bwd_data_tangent"),
    ("dcn_fwd_kernel", "dcn_fwd"),
    ("dcn_bwd_data_kernel", "dcn_bwd_data"),
    ("dcn_bwd_weight_kernel", "dcn_bwd_weight"),
    ("warp_bwd_tangent_kernel", "warp_bwd_tangent"),
    ("warp_fwd_kernel", "warp_fwd"),
    ("warp_bwd_kernel", "warp_bwd"),
    ("duf_fwd_kernel", "duf_fwd"),
    ("duf_bwd_x_kernel", "duf_bwd"),
    ("duf_bwd_kernel", "duf_bwd"),
    ("fwd::to_channels_last", "dcn_fwd helpers"),
    ("bwd::gx_", "dcn_bwd_data helpers"),
    ("bwd::gw_", "dcn_bwd_weight helpers"),
    ("tng::sum_parts", "dcn_fwd_tangent helpers"),
    ("tng::gw_tangent_to_oihw", "dcn_bwd_weight_tangent helpers"),
    ("wgrad", "conv wgrad"),
    ("dgrad", "conv dgrad"),
    ("fft", "conv fft"),
    ("_complex", "conv fft"),
    ("fprop", "conv fprop"),
    ("convolve", "conv fprop"),
    ("winograd", "conv fprop"),
    ("implicit_gemm", "conv fprop"),
    ("gemm", "gemm"),
    ("memcpy", "memcpy"),
    ("memset", "memset"),
    ("nchwtonhwc", "layout transform"),
    ("nhwctonchw", "layout transform"),
    ("transform", "layout transform"),
    ("bn_", "batch norm"),
    ("batch_norm", "batch norm"),
    ("softmax", "softmax"),
    ("upsample", "interpolate"),
    ("catarray", "cat"),
    ("reduce", "reduction"),
    ("elementwise", "elementwise"),
    ("index", "index / gather / scatter"),
    ("gather", "index / gather / scatter"),
    ("scatter", "index / gather / scatter"),
)
PROFILE_TRIES = 3  # profiles taken on a card until one holds device events
PROFILE_MIN_MS = 20.0  # a profile spans at least this much: calls of a shorter workload repeat
# The launch counter of each wrapper (ops/*.launch_counts) by the label its
# kernel carries: warp_fwd_tangent launches K12's kernel with T alone.
COUNTER_LABEL = {"warp_fwd_tangent": "warp_bwd_tangent"}


def kernel_label(name: str) -> str:
    """A device kernel's (or copy's) label for the table."""
    low = name.lower()
    for part, label in LABELS:
        if part.lower() in low:
            return label
    return "other"


def launch_label(counter: str) -> str:
    """The label under which a launch counter's kernel shows in the table."""
    return COUNTER_LABEL.get(counter, counter)


def op_table(prof, top: int = 15, dump: int = 0, calls: int = 1) -> dict:
    """The profile's top `top` labels by time a call (of `calls`),
    descending: device time by kernel_label where the profile holds device
    events, else the host operators' self time by name. Returns rows
    [(label, ms)], their sum
    `top_ms`, the time over every label `total_ms` (>= top_ms), every
    label's time `by_label` (descending), the
    device's busy time `busy_ms` (None on the host), which clock `on`
    ('device' or 'host'), and the `dump` longest raw names [(name, ms)]."""
    totals: Dict[str, float] = {}
    raw: Dict[str, float] = {}
    events = device_events(prof)
    if events:
        on, busy = "device", busy_us(events) / 1e3 / calls
        for e in events:
            label = kernel_label(e.name)
            totals[label] = totals.get(label, 0.0) + e.us / 1e3 / calls
            raw[e.name] = raw.get(e.name, 0.0) + e.us / 1e3 / calls
    else:
        on, busy = "host", None
        for avg in prof.key_averages():
            totals[avg.key] = totals.get(avg.key, 0.0) + avg.self_cpu_time_total / 1e3 / calls
            raw[avg.key] = totals[avg.key]
    by_label = dict(sorted(totals.items(), key=lambda kv: -kv[1]))
    rows = list(by_label.items())[:top]
    return dict(rows=rows, top_ms=sum(ms for _, ms in rows), total_ms=sum(totals.values()),
                busy_ms=busy, on=on, by_label=by_label,
                raw=sorted(raw.items(), key=lambda kv: -kv[1])[:dump])


def _edvr(device, groups: int, nf: int = 64, front_RBs: int = 5, back_RBs: int = 10):
    """EDVR-M (configs/test/test_DynaVSR_Vid4.yml's widths), bf16."""
    return define_G({"network_G": {"which_model_G": "EDVR", "nf": nf, "nframes": 5,
                                   "groups": groups, "front_RBs": front_RBs,
                                   "back_RBs": back_RBs, "dtype": "bf16"}}, device).eval()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_workload(name: str, device, groups: int = 8, **shape) -> Callable[[float], object]:
    """The workload's call: call(eps) runs it once on inputs moved by eps
    (the JAX tool profiles its second call on inputs moved by 1e-3) and
    returns when the device is done. `shape` overrides the workload's
    sizes (b, h, w, ...) and EDVR's widths (nf, front_RBs, back_RBs)."""
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*size, dtype=torch.float32):
        return torch.rand(size, generator=gen, device=device).to(dtype)

    net_kw = {k: shape.pop(k) for k in ("nf", "front_RBs", "back_RBs") if k in shape}
    if name == "edvr_fwd":
        b, h, w = shape.get("b", 4), shape.get("h", 144), shape.get("w", 176)
        net, x = _edvr(device, groups, **net_kw), rand(b, 5, h, w, 3)

        def call(eps):
            with torch.no_grad():
                out = net(x + eps)
            _sync(device)
            return out
    elif name == "dcn":
        b, c = shape.get("b", 20), shape.get("c", 64)
        h, w = shape.get("h", 144), shape.get("w", 176)
        bf = torch.bfloat16
        x, off = rand(b, c, h, w, dtype=bf), ((rand(b, 2 * groups * 9, h, w) - 0.5) * 4).to(bf)
        m, wgt = rand(b, groups * 9, h, w, dtype=bf), (rand(c, c, 3, 3) * 0.1).to(bf)

        def call(eps):
            with torch.no_grad():
                out = dcn.deform_conv2d(x + eps, off, m, wgt, None, groups)
            _sync(device)
            return out
    elif name in ("tof", "duf"):
        b = shape.get("b", 4)
        h, w = (shape.get("h", 576), shape.get("w", 704)) if name == "tof" else (
            shape.get("h", 144), shape.get("w", 176))
        which = "TOF" if name == "tof" else "DUF_16L"
        net = define_G({"network_G": {"which_model_G": which, "nframes": 7, "dtype": "bf16"}},
                       device).eval()
        x = rand(b, 7, h, w, 3)

        def call(eps):
            with torch.no_grad():
                out = net(x + eps)
            _sync(device)
            return out
    elif name == "adapt_only":
        n, h, w = shape.get("n", 8), shape.get("h", 36), shape.get("w", 44)
        net, adapt = _edvr(device, groups, **net_kw), make_adapt_fn(AdaptConfig(n_steps=5))
        slr, lrc = rand(n, 5, h, w, 3), rand(n, 4 * h, 4 * w, 3)

        def call(eps):
            _, losses = adapt(net, slr + eps, lrc)
            return losses.cpu()
    elif name == "stream_step":
        h, w = shape.get("h", 144), shape.get("w", 176)
        stream = StreamingSR(_edvr(device, groups, **net_kw), n_frames=5)
        frame = rand(h, w, 3)
        for s in range(2 * stream.n):  # fill the ring: every later push emits one frame
            stream.push(frame + s * 1e-3)

        def call(eps):
            out = stream.push(frame + eps)
            _sync(device)
            return out
    elif name == "adapt":
        f, n = shape.get("f", 16), shape.get("n", 8)
        h, w = shape.get("h", 144), shape.get("w", 176)
        net = _edvr(device, groups, **net_kw)
        run = make_adapt_and_infer(AdaptConfig(n_steps=5, infer_chunk=0))
        lw, slr = rand(f, 5, h, w, 3), rand(n, 5, h // 4, w // 4, 3)
        lrc = rand(n, h, w, 3)

        def call(eps):
            sr, _ = run(net, slr, lrc, lw + eps)
            _sync(device)
            return sr
    else:
        raise ValueError(f"unknown workload {name!r} (one of {', '.join(WORKLOADS)})")
    return call


def _counts() -> dict:
    return {**dcn.launch_counts(), **warp.launch_counts(), **duf_filter.launch_counts()}


def _reset_counts() -> None:
    dcn.reset_launch_counts()
    warp.reset_launch_counts()
    duf_filter.reset_launch_counts()


def profile_workload(name: str, device=None, groups: int = 8, top: int = 15, dump: int = 0,
                     trace_dir: Optional[str] = None, **shape) -> dict:
    """Warmed calls of workload `name` under profile_trace (its trace in
    `trace_dir`, default a new temp dir): one call, or as many as span
    PROFILE_MIN_MS where one call takes less (timed on a second warm-up
    call), the table then per call. Late in a process that had profiled
    for minutes, the profile of the single 3 ms `dcn` call caught no device
    event in 4 of 5 runs, and in none of 5 tries once; on a card a profile
    without one is taken again, up to PROFILE_TRIES in all. Returns
    op_table's reading plus the profiled `window_ms` a call (host clock),
    the kernels' `launches` a call (nonzero counters), the device, the
    trace dir, the `calls` a profile and the profiles taken (`tries`)."""
    device = resolve_device(device)
    torch.manual_seed(0)
    call = make_workload(name, device, groups, **shape)
    call(0.0)  # warm-up: cuDNN plans, kernel loads
    t0 = time.perf_counter()
    call(0.0)
    calls = max(1, math.ceil(PROFILE_MIN_MS / ((time.perf_counter() - t0) * 1e3)))
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="torchprof_")
    for tries in range(1, PROFILE_TRIES + 1):
        _reset_counts()
        with profile_trace(trace_dir) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                call(1e-3)
            window_ms = (time.perf_counter() - t0) * 1e3 / calls
        table = op_table(prof, top, dump, calls)
        if table["on"] == "device" or device.type != "cuda":
            break
    launches = {k: v // calls for k, v in _counts().items() if v}
    return dict(table, workload=name, groups=groups, device=str(device), window_ms=window_ms,
                launches=launches, trace_dir=trace_dir, calls=calls, tries=tries)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="edvr_fwd", choices=list(WORKLOADS))
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--dump", type=int, default=0,
                    help="also print the N longest RAW kernel (host op) names "
                         "(identifies what the `other` label holds)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; a host without a card raises) or cpu")
    return ap


def print_table(res: dict) -> None:
    """The reading as the JAX tool prints its table."""
    if res["raw"]:
        print(f"--- top {len(res['raw'])} raw names ---")
        for raw_name, ms in res["raw"]:
            print(f"  {ms:9.3f} ms  {raw_name[:240]}")
    print(f"top {len(res['rows'])} ops ({res['workload']}, groups={res['groups']}, "
          f"{res['on']} time a call of {res['calls']} on {res['device']}):")
    for label, ms in res["rows"]:
        print(f"  {ms:9.3f} ms  {label}")
    busy = "" if res["busy_ms"] is None else f"; device busy {res['busy_ms']:.3f} ms"
    print(f"  (top-{len(res['rows'])} sum: {res['top_ms']:.3f} ms of {res['total_ms']:.3f} ms"
          f"{busy}; profiled window {res['window_ms']:.3f} ms; launches {res['launches']})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    res = profile_workload(args.workload, args.device, args.groups, args.top, args.dump)
    print_table(res)
    print(json.dumps({k: v for k, v in res.items() if k != "raw"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
