#!/usr/bin/env python3
"""Time the port's warp and DUF kernels (K4-K7) on one card, apart from
their wrappers.

    python3 kernel_times.py [--root DIR] [--tag NAME] [--out FILE]

For each kernel at the call sizes of the TOF and DUF paths (synthetic
inputs from a seed: x, white-noise flows N(0, 1) px, softmaxed filters,
N(0, 1) output gradients):
  ms         CUDA events around 20 back-to-back wrapper calls, the number
             chip_smoke.py's `ms` is (for calls of a few us it measures the
             host);
  kernel_ms  the device time of one launch: the 20 wrapper calls captured
             in a CUDA graph, whose replays are timed with events; one
             replay runs under torch.profiler to check that the graph holds
             the 20 launches;
  host_us    the host time of one wrapper call: the host clock over 200
             calls, with no synchronise inside the loop;
and, for K5, the host time of each piece of its wrapper. `--root` imports
the package of another checkout (a parent tree unpacked with git archive),
so two trees are compared in one call on one card, in turns. Prints one
JSON line a measurement, and the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published H100 SXM peak (NVIDIA data sheet), as chip_smoke.py.
HBM_BYTES_PER_S = 3.35e12
REPS = 20


def graph_ms(fn, reps: int = REPS, replays: int = 20, kernel: str | None = None,
             rtol: float = 0.0):
    """Device time of one `fn()`: `reps` calls captured in a CUDA graph
    (after a warm-up on a side stream), the replays timed with events.
    Checks that the graph's last launch writes its output (NaN-filled after
    the capture, equal to an eager call after a replay: bitwise, or within
    `rtol` of the largest value for a kernel that sums with atomics); with
    `kernel`, also counts that kernel's launches in one replay under the
    profiler. Returns (ms, launches seen, or None where not counted)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    want = [t.clone() for t in _tensors(fn())]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    captured = _tensors(out)
    for t in captured:
        t.fill_(math.nan)
    graph.replay()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) if rtol == 0 else bool(
            (a - b).abs().max() <= rtol * b.abs().max()) for a, b in zip(captured, want)):
        raise RuntimeError("the captured graph's launches did not write their outputs")
    seen = None
    if kernel is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        seen = sum(1 for e in prof.events() if kernel in e.name)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays), seen


def _tensors(out):
    items = out if isinstance(out, (tuple, list)) else (out,)
    return [t for t in items if isinstance(t, torch.Tensor)]


def host_us(fn, n: int = 200, repeats: int = 5) -> float:
    """Host time of one `fn()`: the host clock over n calls with no
    synchronise inside (the device runs behind; 200 launches stay inside
    the launch queue), the median of `repeats` such runs."""
    runs = []
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


def event_ms(fn, reps: int = REPS, warmup: int = 2) -> float:
    """CUDA events around `reps` back-to-back calls, as chip_smoke.cuda_ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose dynavsr_tpu_torch is timed")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device; this script measures the GPU only", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.abspath(args.root))
    from dynavsr_tpu_torch.ops import _build, duf_filter
    from dynavsr_tpu_torch.ops import grid_sample as warp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []

    def emit(row):
        row.update(tag=args.tag, root=args.root, device=smi)
        rows.append(row)
        print(json.dumps(row))

    def timed(name, label, fn, nbytes, kernel):
        ms = event_ms(fn)
        kernel_ms, seen = graph_ms(fn, kernel=kernel)
        if seen not in (0, REPS):  # 0: the profiler sees no kernel inside a graph
            raise RuntimeError(f"{name} {label}: the graph holds {seen} launches, not {REPS}")
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        emit(dict(name=name, label=label, ms=ms, kernel_ms=kernel_ms, host_us=host_us(fn),
                  bound_ms=bound, roofline=bound / ms, kernel_roofline=bound / kernel_ms,
                  graph_launches=seen, graph_reps=REPS))

    def warp_inputs(b, c, h, w):
        x = torch.randn(b, c, h, w, generator=gen, device="cuda")
        flow = torch.randn(b, 2, h, w, generator=gen, device="cuda")
        cot = torch.randn(b, c, h, w, generator=gen, device="cuda")
        return x, flow, cot

    for h, w in ((36, 44), (72, 88), (144, 176)):
        x, flow, cot = warp_inputs(8, 3, h, w)
        px = 8 * h * w
        timed("warp_bwd", f"adapt 8x{h}x{w}", lambda: warp.warp_bwd(x, flow, cot, need_x=False),
              px * (2 * 3 + 4) * 4, "warp_bwd_kernel")
    for h, w in ((144, 176), (576, 704)):
        x, flow, _ = warp_inputs(8, 3, h, w)
        timed("warp_fwd", f"8x{h}x{w}", lambda: warp.warp_fwd(x, flow), 8 * h * w * 8 * 4,
              "warp_fwd_kernel")

    # K5's wrapper, piece by piece, at the adaptation call 8x3x144x176.
    x, flow, cot = warp_inputs(8, 3, 144, 176)
    fn = _build.load("warp_bwd").warp_bwd
    gflow = torch.empty_like(flow)
    stream = _build.stream(x)
    pieces = {
        "grad_out.contiguous": lambda: cot.contiguous(),
        "check": lambda: warp._check(x, flow, cot),
        "empty_like": lambda: torch.empty_like(flow),
        "build.load": lambda: _build.load("warp_bwd"),
        "stream object": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "build.stream": lambda: _build.stream(x),
        "ctypes launch": lambda: fn(x.data_ptr(), flow.data_ptr(), cot.data_ptr(), None,
                                    gflow.data_ptr(), 8, 3, 144, 176, stream),
        "raise_if": lambda: _build.raise_if(0, "warp_bwd"),
        "wrapper": lambda: warp.warp_bwd(x, flow, cot, need_x=False),
    }
    emit(dict(name="warp_bwd", label="host pieces 8x144x176",
              host_us={k: host_us(f) for k, f in pieces.items()}))

    for (h, w), names in (((36, 44), ("duf_fwd", "duf_bwd")), ((144, 176), ("duf_fwd",))):
        for fdtype in (torch.float32, torch.bfloat16):
            x = torch.rand(8, 3, h, w, generator=gen, device="cuda")
            f = torch.softmax(torch.randn(8, 25, 16, h, w, generator=gen, device="cuda"),
                              dim=1).to(fdtype)
            cot = torch.randn(8, 48, h, w, generator=gen, device="cuda")
            px, fe = 8 * h * w, torch.finfo(fdtype).bits // 8
            nbytes = px * 3 * 4 + px * 25 * 16 * fe + px * 48 * 4
            label = f"8x{h}x{w} R16 {str(fdtype).replace('torch.', '')}"
            if "duf_fwd" in names:
                timed("duf_fwd", label, lambda: duf_filter.duf_fwd(x, f), nbytes, "duf_fwd_kernel")
            if "duf_bwd" in names:
                timed("duf_bwd", label, lambda: duf_filter.duf_bwd(x, f, cot, need_x=False),
                      nbytes, "duf_bwd_kernel")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
