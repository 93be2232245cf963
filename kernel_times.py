#!/usr/bin/env python3
"""Time the port's kernels on one card, apart from their wrappers: the
DCN's K1-K3 and its second order K8-K10 at the meta inner step's calls,
the warp's K4 / K5 and its second order K11 / K12 (one kernel, timed in
each of its modes), the DUF filter's K6 / K7.

    python3 kernel_times.py [--root DIR] [--tag NAME] [--out FILE]

For each kernel at the call sizes of its path (synthetic inputs from a
seed: x, white-noise flows N(0, 1) px, softmaxed filters, N(0, 1) output
gradients; for the DCN, 40 frames x 64 channels, Gd 8, at the meta inner
step's pyramid levels 16x16, 8x8 and 4x4, offsets N(0, 0.5^2) px, masks
U(0, 1), offset cotangents N(0, 1)):
  ms         CUDA events around 20 back-to-back wrapper calls, the number
             chip_smoke.py's `ms` is (for calls of a few us it measures the
             host);
  kernel_ms  the device time of one launch: the 20 wrapper calls captured
             in a CUDA graph, whose replays are timed with events; one
             replay runs under torch.profiler to check that the graph holds
             the 20 launches;
  host_us    the host time of one wrapper call: the host clock over 200
             calls, with no synchronise inside the loop;
and, for K5 and K10, the host time of each piece of their wrappers; for
K8 and K10 (where the tree has their launchers' `split` argument) each
split of a tile's taps over blocks (1, 3, 9) beside the launcher's own
choice. `--root` imports the package of another checkout (a parent tree
unpacked with git archive), so two trees are compared in one call on one
card, in turns. Prints one JSON line a measurement, and the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import os
import subprocess
import sys
import time

import torch

# Published H100 SXM peaks (NVIDIA data sheet), as chip_smoke.py.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # off the tensor cores (TF32 off)
REPS = 20


def graph_ms(fn, reps: int = REPS, replays: int = 20, kernel: str | None = None,
             rtol=0.0):
    """Device time of one `fn()`: `reps` calls captured in a CUDA graph
    (after a warm-up on a side stream), the replays timed with events.
    Checks that the graph's last launch writes its output (NaN-filled after
    the capture, equal to an eager call after a replay: bitwise, or within
    `rtol` of the largest value for a kernel that sums with atomics; a
    sequence gives each output its own); with `kernel`, also counts that
    kernel's launches in one replay under the profiler. Returns (ms,
    launches seen, or None where not counted)."""
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
    tols = rtol if isinstance(rtol, (tuple, list)) else [rtol] * len(want)
    if not all(torch.equal(a, b) if tol == 0 else bool(
            (a - b).abs().max() <= tol * b.abs().max())
            for a, b, tol in zip(captured, want, tols)):
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


def dcn_times(timed, emit, gen) -> None:
    """K1-K3 and K8-K10 at the meta inner step's calls (40 x 64 x {16, 8,
    4}^2, Gd 8, fp32): the wrappers, then K8's and K10's launchers with
    each split of a tile's taps, then K10's wrapper piece by piece."""
    from dynavsr_tpu_torch.ops import _build, dcn

    b, c, gd = 40, 64, 8
    new = hasattr(dcn, "fwd_tangent_splits")  # a tree with the split argument
    # K1 at EDVR's inference call (40 x 144x176) and K2 / K3 at its
    # adaptation call (40 x 36x44), fp32 and bf16 (chip_smoke.py's phase 7
    # shapes), so that a change to the shared DCN code shows there too.
    for kind, h, w, names in (("infer", 144, 176, ("dcn_fwd",)),
                              ("adapt", 36, 44, ("dcn_bwd_data", "dcn_bwd_weight"))):
        for dtype in (torch.float32, torch.bfloat16):
            px, e = b * h * w, torch.finfo(dtype).bits // 8
            x = torch.randn(b, c, h, w, generator=gen, device="cuda").to(dtype)
            x_cl = x.contiguous(memory_format=torch.channels_last)
            offset = (torch.randn(b, 2 * gd * 9, h, w, generator=gen, device="cuda")
                      * 0.5).to(dtype)
            mask = torch.rand(b, gd * 9, h, w, generator=gen, device="cuda").to(dtype)
            weight = (torch.randn(c, c, 3, 3, generator=gen, device="cuda")
                      / (c * 9) ** 0.5).to(dtype)
            bias = torch.randn(c, generator=gen, device="cuda").to(dtype)
            cot = torch.randn(b, c, h, w, generator=gen, device="cuda").to(dtype)
            xb, ob, mb, wb = px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e, c * c * 9 * e
            flops = 2 * px * c * c * 9 if dtype == torch.float32 else 0  # bf16: tensor cores
            label = f"{kind} {b}x{h}x{w} {str(dtype).replace('torch.', '')}"
            tol = 1e-5 if dtype == torch.float32 else 2 ** -7  # atomics, then one rounding
            calls = {
                "dcn_fwd": (lambda: dcn.dcn_fwd(x, offset, mask, weight, bias, gd),
                            xb + ob + mb + wb + px * c * e, 0.0),
                "dcn_bwd_data": (lambda: dcn.dcn_bwd_data(x_cl, offset, mask, weight, cot, gd),
                                 2 * xb + 2 * ob + 2 * mb + wb + px * c * e, (tol, 0.0, 0.0)),
                "dcn_bwd_weight": (lambda: dcn.dcn_bwd_weight(x_cl, offset, mask, cot, gd),
                                   xb + ob + mb + px * c * e + wb, tol),
            }
            for name in names:
                fn, nbytes, rtol = calls[name]
                timed(name, label, fn, nbytes, None, rtol=rtol, flops=flops)

    for h in (16, 8, 4):
        px, label = b * h * h, f"meta {b}x{h}x{h}"
        x = torch.randn(b, c, h, h, generator=gen, device="cuda")
        x_cl = x.contiguous(memory_format=torch.channels_last)
        offset = torch.randn(b, 2 * gd * 9, h, h, generator=gen, device="cuda") * 0.5
        mask = torch.rand(b, gd * 9, h, h, generator=gen, device="cuda")
        weight = torch.randn(c, c, 3, 3, generator=gen, device="cuda") / (c * 9) ** 0.5
        bias = torch.randn(c, generator=gen, device="cuda")
        cot = torch.randn(b, c, h, h, generator=gen, device="cuda")
        coff = torch.randn(offset.shape, generator=gen, device="cuda")
        # Bytes: each input read once, each output written once; operations:
        # the 2 B HW C Cout 9 product (chip_smoke.tangent_bound's rule).
        e, flops = 4, 2 * px * c * c * 9
        xb, ob, mb, wb = px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e, c * c * 9 * e
        calls = {
            "dcn_fwd": (lambda: dcn.dcn_fwd(x, offset, mask, weight, bias, gd),
                        xb + ob + mb + wb + px * c * e, 0.0),
            "dcn_bwd_data": (lambda: dcn.dcn_bwd_data(x_cl, offset, mask, weight, cot, gd),
                             2 * xb + 2 * ob + 2 * mb + wb + px * c * e, (1e-5, 0.0, 0.0)),
            "dcn_bwd_weight": (lambda: dcn.dcn_bwd_weight(x_cl, offset, mask, cot, gd),
                               xb + ob + mb + px * c * e + wb, 1e-5),
            "dcn_fwd_tangent": (lambda: dcn.dcn_fwd_tangent(x_cl, offset, mask, weight, coff, gd),
                                xb + 2 * ob + mb + wb + px * c * e, 0.0),
            "dcn_bwd_weight_tangent": (
                lambda: dcn.dcn_bwd_weight_tangent(x_cl, offset, mask, cot, coff, gd),
                xb + 2 * ob + mb + px * c * e + wb, 1e-5),
            # PR 9's K10 summed its offset and mask gradients with atomics too.
            "dcn_bwd_data_tangent": (
                lambda: dcn.dcn_bwd_data_tangent(x_cl, offset, mask, weight, cot, coff, gd),
                2 * xb + 3 * ob + 2 * mb + wb + px * c * e, (1e-5, 0.0, 0.0) if new else 1e-5),
        }
        for name, (fn, nbytes, rtol) in calls.items():
            timed(name, label, fn, nbytes, None, rtol=rtol, flops=flops)
        if not new:
            continue
        lib = _build.load("dcn_tangent")
        wt8 = weight.permute(2, 3, 1, 0).reshape(9, c, c).contiguous()
        wt10 = weight.permute(2, 3, 0, 1).reshape(9, c, c).contiguous()
        out = torch.empty_like(cot)
        part = torch.empty(8 * out.numel(), device="cuda")
        gx = torch.empty(b, h, h, c, device="cuda")
        goff, gmask = torch.empty_like(offset), torch.empty_like(mask)
        chosen = dcn.fwd_tangent_splits(b, c, h, h, c, gd, x.get_device())
        for split in (1, 3, 9):
            def k8(split=split):
                _build.raise_if(lib.dcn_fwd_tangent(
                    x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(), coff.data_ptr(),
                    wt8.data_ptr(), out.data_ptr(), part.data_ptr(), b, c, h, h, c, gd, split,
                    _build.stream(x)), "dcn_fwd_tangent")
                return out

            def k10(split=split):
                _build.raise_if(lib.dcn_bwd_data_tangent(
                    x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(), coff.data_ptr(),
                    wt10.data_ptr(), cot.data_ptr(), gx.data_ptr(), goff.data_ptr(),
                    gmask.data_ptr(), b, c, h, h, c, gd, split, _build.stream(x)),
                    "dcn_bwd_data_tangent")
                return gx, goff, gmask

            timed("dcn_fwd_tangent", f"{label} split {split}", k8,
                  calls["dcn_fwd_tangent"][1], None, flops=flops, chosen=chosen)
            timed("dcn_bwd_data_tangent", f"{label} split {split}", k10,
                  calls["dcn_bwd_data_tangent"][1], None, rtol=(1e-5, 0.0, 0.0), flops=flops)
        if h == 16:  # K10's wrapper, piece by piece
            fn = lib.dcn_bwd_data_tangent
            pieces = {
                "tangent_args": lambda: dcn._tangent_args(
                    x_cl, offset, mask, coff, gd, c, "K10", weight=weight, grad_out=cot),
                "weight permute": lambda: weight.permute(2, 3, 0, 1).reshape(9, c, c)
                .contiguous(),
                "empty x3": lambda: (torch.empty((b, h, h, c), device=x.device),
                                     torch.empty_like(offset), torch.empty_like(mask)),
                "build.load": lambda: _build.load("dcn_tangent"),
                "ctypes launch": lambda: fn(
                    x_cl.data_ptr(), offset.data_ptr(), mask.data_ptr(), coff.data_ptr(),
                    wt10.data_ptr(), cot.data_ptr(), gx.data_ptr(), goff.data_ptr(),
                    gmask.data_ptr(), b, c, h, h, c, gd, 0, _build.stream(x)),
                "wrapper": lambda: dcn.dcn_bwd_data_tangent(x_cl, offset, mask, weight, cot,
                                                            coff, gd),
            }
            emit(dict(name="dcn_bwd_data_tangent", label=f"host pieces {label}",
                      host_us={k: host_us(f) for k, f in pieces.items()}))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose dynavsr_tpu_torch is timed")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="also write the measurements to this JSON file")
    ap.add_argument("--only", choices=("dcn", "warp", "duf"),
                    help="time only the DCN's, the warp's or the filter's kernels")
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

    def timed(name, label, fn, nbytes, kernel, rtol=0.0, flops=0, **extra):
        ms = event_ms(fn)
        kernel_ms, seen = graph_ms(fn, kernel=kernel, rtol=rtol)
        if kernel is not None and seen not in (0, REPS):  # 0: no kernel seen inside a graph
            raise RuntimeError(f"{name} {label}: the graph holds {seen} launches, not {REPS}")
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        emit(dict(name=name, label=label, ms=ms, kernel_ms=kernel_ms, host_us=host_us(fn),
                  bound_ms=bound, bound_by="bytes" if t_bytes >= t_ops else "operations",
                  roofline=bound / ms, kernel_roofline=bound / kernel_ms, graph_launches=seen,
                  graph_reps=REPS, **extra))

    if args.only in (None, "dcn"):
        dcn_times(timed, emit, gen)

    if args.only in (None, "warp"):
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

        # K11 / K12 at TOF's meta-training calls (8 windows): the inner step's
        # SLR pre-upscaled to 64x64 (where a meta update runs them) and the outer
        # 256x256: T alone, grad flow alone, both in one launch (a tree whose
        # warp_bwd_tangent takes need_t: the double backward's call), grad
        # flow with grad x (summed with atomics). Bytes: each input read once,
        # each output written once (chip_smoke.warp_tangent_bound's rule).
        if hasattr(warp, "warp_fwd_tangent"):  # an older checkout (--root) has none
            one_launch = "need_t" in inspect.signature(warp.warp_bwd_tangent).parameters
            k11 = "warp_bwd_tangent_kernel" if one_launch else "warp_fwd_tangent_kernel"
            for h, w in ((64, 64), (256, 256)):
                x, flow, cot = warp_inputs(8, 3, h, w)
                cflow = torch.randn(8, 2, h, w, generator=gen, device="cuda")
                px = 8 * h * w
                timed("warp_fwd_tangent", f"meta 8x{h}x{w}",
                      lambda: warp.warp_fwd_tangent(x, flow, cflow), px * (2 * 3 + 4) * 4, k11)
                timed("warp_bwd_tangent", f"meta 8x{h}x{w}",
                      lambda: warp.warp_bwd_tangent(x, flow, cot, cflow, need_x=False),
                      px * (2 * 3 + 6) * 4, "warp_bwd_tangent_kernel")
                if one_launch:
                    timed("warp_bwd_tangent", f"meta 8x{h}x{w} +T",
                          lambda: warp.warp_bwd_tangent(x, flow, cot, cflow, need_x=False,
                                                        need_t=True),
                          px * (3 * 3 + 6) * 4, "warp_bwd_tangent_kernel")
                timed("warp_bwd_tangent", f"meta 8x{h}x{w} +grad x",
                      lambda: warp.warp_bwd_tangent(x, flow, cot, cflow, need_x=True),
                      px * (3 * 3 + 6) * 4, "warp_bwd_tangent_kernel", rtol=1e-5)

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

    if args.only in (None, "duf"):
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
                    timed("duf_fwd", label, lambda: duf_filter.duf_fwd(x, f), nbytes,
                          "duf_fwd_kernel")
                if "duf_bwd" in names:
                    timed("duf_bwd", label, lambda: duf_filter.duf_bwd(x, f, cot, need_x=False),
                          nbytes, "duf_bwd_kernel")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
