#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dynavsr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases; any failure raises and exits non-zero:
  1. device   the card's name, count, and nvidia-smi's name and power limit
              (no card: exit 2, no result printed);
  2. build    nvcc builds the DCN kernels from csrc/ (one process per
              source, in parallel) and prints ptxas' register/smem lines;
  3. kernels  K1 dcn_fwd, K2 dcn_bwd_data and K3 dcn_bwd_weight against the
              plain PyTorch version (ops/dcn_ref.py and its autograd) at
              Gd 8, 2, 1 in fp32 and bf16, at the main path's two L1 DCN
              shapes (inference: 40 frames of 144x176; adaptation: 40 SLR
              frames of 36x44; C = Cout = 64), on white-noise offsets that
              reach outside the image (a correctness check, not timed);
  4. main     the DynaVSR adapt-and-infer loop at full EDVR-M x4 + MFDN
              width (configs/test/test_DynaVSR_Vid4.yml), random weights
              from a seed, on a synthetic 16-frame 144x176 clip, through
              cli/test_dynavsr.run_clip: window-batched and sequence mode,
              fp32 and bf16. Checks finite losses, window == seq (fp32),
              non-zero launches of all three kernels, and one window of
              EDVR with the kernels against EDVR with the plain DCN; then
              one clip per dtype under torch.profiler (device time by
              kernel, the DCN share, the device's idle share), and one
              whose DCN calls are recorded;
  5. timing   each kernel, checked again and timed with CUDA events on the
              inputs the main path gave it (every distinct DCN call of a
              window-batched clip: offsets, masks and gradients from the
              network itself); their sum over a clip's launches is set
              beside the profiler's device time for the same kernels.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
from dynavsr_tpu_torch.cli.test_dynavsr import build_edvr, build_mfdn, run_clip
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import score_frames
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.ops import _build, dcn
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 off the tensor cores
SEED = 0

# configs/test/test_DynaVSR_Vid4.yml
EDVR_M = {"which_model_G": "EDVR", "nf": 64, "nframes": 5, "groups": 8,
          "front_RBs": 5, "back_RBs": 10, "w_TSA": True}
MFDN_NF, N_WINDOWS, INFER_CHUNK = 64, 8, 8
CLIP_T, LR_H, LR_W, SCALE = 16, 144, 176, 4  # bench.py:127's clip
# The L1 DCN shapes of that path: inference chunks of 8 windows x 5 frames
# at the LR size; adaptation on 8 SLR windows x 5 frames at LR/4.
INFER_L1, ADAPT_L1 = (40, 64, LR_H, LR_W), (40, 64, LR_H // 4, LR_W // 4)


def dcn_label(kind: str, shape) -> str:
    return f"{kind} {'x'.join(map(str, (shape[0], *shape[2:])))}"


DCN_SHAPES = {dcn_label("infer", INFER_L1): INFER_L1, dcn_label("adapt", ADAPT_L1): ADAPT_L1}
# name: (source, the DCN call whose timing stands in the JSON line)
KERNELS = {
    "dcn_fwd": ("dynavsr_tpu_torch/csrc/dcn_fwd.cu", dcn_label("infer", INFER_L1)),
    "dcn_bwd_data": ("dynavsr_tpu_torch/csrc/dcn_bwd.cu", dcn_label("adapt", ADAPT_L1)),
    "dcn_bwd_weight": ("dynavsr_tpu_torch/csrc/dcn_bwd.cu", dcn_label("adapt", ADAPT_L1)),
}
REPLACES = "dynavsr_tpu/ops/dcn_fused.py:100"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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


# ------------------------------------------------------------- phase 1, 2
def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU only",
              file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {name} x{torch.cuda.device_count()}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    print(smi)
    resolve_device()  # the port's precision policy on the card: TF32 off
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is still on")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 3
def dcn_inputs(shape, gd, dtype, gen):
    b, c, h, w = shape
    dev = "cuda"

    def rnd(*s):
        return torch.randn(*s, generator=gen, device=dev)

    x = rnd(b, c, h, w)
    # Non-integer offsets of a few pixels: some samples fall outside.
    offset = rnd(b, 2 * gd * 9, h, w) * 2.0 + 0.37
    mask = torch.rand(b, gd * 9, h, w, generator=gen, device=dev)
    weight = rnd(c, c, 3, 3) / math.sqrt(9 * c)
    bias = rnd(c)
    cot = rnd(b, c, h, w)
    return [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]


def dcn_bound(name, shape, gd, dtype):
    """(bound_ms, bound_by, bytes, flops): each input read once, each output
    written once; operations = the 2*B*HW*C*Cout*9 contraction."""
    b, c, h, w = shape
    px, e = b * h * w, torch.finfo(dtype).bits // 8
    x, off, msk, wgt = px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e, c * c * 9 * e
    if name == "dcn_fwd":
        nbytes = x + off + msk + wgt + c * e + px * c * e
    elif name == "dcn_bwd_data":
        nbytes = (x + off + msk + wgt + px * c * e) + (x + off + msk)
    else:
        nbytes = x + off + msk + px * c * e + wgt
    flops = 2 * px * c * c * 9
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def against_plain(label, x, offset, mask, weight, bias, cot, gd, timed):
    """Hold each kernel (K1; K2 and K3 when a cotangent is given) against
    the plain version in fp32 on the same input values, raise if one
    disagrees, and with `timed` time both with CUDA events. Tolerance
    relative to the plain result's largest value: fp32 1e-4 (same
    arithmetic, another order; K2/K3 atomics), bf16 2^-7 (one rounding of
    the kernels' fp32 result to bf16, with margin)."""
    names = list(KERNELS) if cot is not None else ["dcn_fwd"]
    dtype, shape = x.dtype, tuple(x.shape)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    ref_in = [t.detach().float().requires_grad_() for t in (x, offset, mask, weight, bias)]
    ref = deform_conv2d_ref(*ref_in, deformable_groups=gd)
    got = {"dcn_fwd": [dcn.dcn_fwd(x, offset, mask, weight, bias, gd)]}
    want = {"dcn_fwd": [ref]}
    if cot is not None:
        ref_grads = torch.autograd.grad(ref, ref_in[:4], cot.float(), retain_graph=True)
        got["dcn_bwd_data"] = list(dcn.dcn_bwd_data(x, offset, mask, weight, cot, gd))
        got["dcn_bwd_weight"] = [dcn.dcn_bwd_weight(x, offset, mask, cot, gd)]
        want["dcn_bwd_data"], want["dcn_bwd_weight"] = list(ref_grads[:3]), [ref_grads[3]]
    torch.cuda.synchronize()
    plain = {
        "dcn_fwd": lambda: deform_conv2d_ref(*ref_in, deformable_groups=gd),
        "dcn_bwd_data": lambda: torch.autograd.grad(
            ref, ref_in[:3], cot.float(), retain_graph=True),
        "dcn_bwd_weight": lambda: torch.autograd.grad(
            ref, ref_in[3], cot.float(), retain_graph=True),
    }
    launch = {  # the wrappers, as the main path calls them (zero-fills and casts included)
        "dcn_fwd": lambda: dcn.dcn_fwd(x, offset, mask, weight, bias, gd),
        "dcn_bwd_data": lambda: dcn.dcn_bwd_data(x, offset, mask, weight, cot, gd),
        "dcn_bwd_weight": lambda: dcn.dcn_bwd_weight(x, offset, mask, cot, gd),
    }
    rows = []
    for name in names:
        err = max(float((g.float() - r.detach()).abs().max())
                  for g, r in zip(got[name], want[name]))
        scale = max(float(r.detach().abs().max()) for r in want[name])
        ok = err <= tol * scale
        row = dict(name=name, label=label, dims=list(shape), gd=gd,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err, tol=tol * scale)
        line = (f"{name:14s} {label} {shape} Gd={gd} {row['dtype']:8s} "
                f"max|err| {err:.3e} (tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if timed:
            ms = cuda_ms(launch[name], reps=10)
            plain_ms = cuda_ms(plain[name], reps=3, warmup=1)
            bound_ms, bound_by, nbytes, flops = dcn_bound(name, shape, gd, dtype)
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                       bytes=nbytes, flops=flops, gb_per_s=nbytes / ms / 1e6,
                       tflops=flops / ms / 1e9, roofline=bound_ms / ms)
            line += (f"  {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {bound_ms:.3f} ms "
                     f"({bound_by}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.1f} GFLOP)  "
                     f"{row['gb_per_s']:.0f} GB/s  {row['tflops']:.1f} TFLOP/s  "
                     f"roofline {row['roofline']:.1%}")
        print(f"[{'timing' if timed else 'kernel'}] {line}")
        check(ok, f"{name} {label} {shape} Gd={gd} {dtype}: {err} > {tol * scale}")
        rows.append(row)
    return rows


def phase_kernels() -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape_name, shape in DCN_SHAPES.items():
        for gd in (8, 2, 1):
            for dtype in (torch.float32, torch.bfloat16):
                x, offset, mask, weight, bias, cot = dcn_inputs(shape, gd, dtype, gen)
                against_plain(shape_name, x, offset, mask, weight, bias, cot, gd, timed=False)
                del x, offset, mask, weight, bias, cot
                torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights: U(+-1/sqrt(fan_in)) like torch's default conv init,
    scaled by 0.1 in residual blocks (the reference's initialize_weights)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan_in = p[0].numel() if p.dim() > 1 else p.numel()
            scale = 0.1 if ("feature_extraction" in name or "recon_trunk" in name) else 1.0
            p.copy_((torch.rand(p.shape, generator=gen, device=p.device) * 2 - 1)
                    * scale / math.sqrt(fan_in))


def synthetic_clip(gen: torch.Generator):
    """A smooth 16-frame HR clip (moving sinusoids, values in (0, 1)) and
    its LR = the port's MATLAB-bicubic imresize(HR, 1/4)."""
    h, w = LR_H * SCALE, LR_W * SCALE
    dev = "cuda"
    y = torch.arange(h, device=dev).view(1, h, 1, 1) / h
    x = torch.arange(w, device=dev).view(1, 1, w, 1) / w
    t = torch.arange(CLIP_T, device=dev).view(CLIP_T, 1, 1, 1)
    acc = torch.zeros(CLIP_T, h, w, 3, device=dev)
    for _ in range(6):
        fy, fx, vy, vx, ph = (torch.rand(5, generator=gen, device=dev) * torch.tensor(
            [6.0, 6.0, 0.05, 0.05, 6.28], device=dev)).unbind()
        amp = torch.rand(3, generator=gen, device=dev) * 0.6 + 0.2
        acc += amp * torch.sin(2 * math.pi * (fy * (y + vy * t) + fx * (x + vx * t)) + ph)
    hr = 0.5 + 0.45 * torch.tanh(acc / 2)
    lr = imresize(hr, 1.0 / SCALE)
    return lr.cpu().numpy(), hr.cpu().numpy()


def phase_main(smi: str):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lq, gt = synthetic_clip(gen)
    vsr32 = build_edvr(EDVR_M)  # the entry points' default device: the card
    init_weights(vsr32, gen)
    vsr16 = build_edvr({**EDVR_M, "dtype": "bfloat16"})
    vsr16.load_state_dict(vsr32.state_dict())
    est = build_mfdn({"nf": MFDN_NF}, SCALE, EDVR_M["nframes"])
    init_weights(est, gen)
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    nf = EDVR_M["nframes"]

    def clip(model, seq):
        return run_clip(model, est, lq, None, cfg, seq=seq, n_frames=nf,
                        padding="reflection", n_adapt=N_WINDOWS)

    for model in (vsr32, vsr16):  # warm-up: cuDNN handles, kernel loads
        clip(model, seq=False)

    dcn.reset_launch_counts()
    results = {}
    for dt_name, model in (("fp32", vsr32), ("bf16", vsr16)):
        for seq in (False, True):
            mode = f"{dt_name}-{'seq' if seq else 'windows'}"
            before = dcn.launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sr, res = clip(model, seq)
            secs = time.perf_counter() - t0  # run_clip returns host arrays: synchronised
            peak = torch.cuda.max_memory_allocated()
            counts = {k: v - before[k] for k, v in dcn.launch_counts().items()}
            losses = res["adapt_losses"]
            check(len(losses) == 5 and all(math.isfinite(v) for v in losses),
                  f"{mode}: adaptation losses {losses}")
            check(sr.shape == gt.shape and bool(np.isfinite(sr).all()), f"{mode}: SR output")
            score = score_frames(sr, gt, ycbcr=True, crop_border=0)
            results[mode] = dict(sr=sr, fps=CLIP_T / secs, secs=secs, peak=peak,
                                 losses=losses, counts=counts, psnr=score["psnr_avg"],
                                 ssim=score["ssim_avg"])
            print(f"[main] {mode:13s} {CLIP_T / secs:.3f} frames/s ({secs:.3f} s/clip) "
                  f"peak {peak / 2**30:.2f} GiB  PSNR-Y {score['psnr_avg']:.3f} "
                  f"SSIM {score['ssim_avg']:.4f}  losses {[f'{v:.6f}' for v in losses]}  "
                  f"launches {counts}  [{smi}]")
    launches = dcn.launch_counts()
    print(f"[main] launches over the four clips: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")

    d32 = float(np.abs(results["fp32-windows"]["sr"] - results["fp32-seq"]["sr"]).max())
    d16 = float(np.abs(results["bf16-windows"]["sr"] - results["bf16-seq"]["sr"]).max())
    print(f"[main] max |windows - seq|: fp32 {d32:.3e} (limit 1e-4), bf16 {d16:.3e}")
    check(d32 <= 1e-4, f"fp32 window-batched and sequence mode differ by {d32}")

    # One window through EDVR with the kernels and with the plain DCN.
    win = torch.as_tensor(lq[all_windows(CLIP_T, nf, "reflection")[:1]], device="cuda")
    kernel_fn = edvr_module.deform_conv2d
    with torch.no_grad():
        sr_kernel = vsr32(win)
        edvr_module.deform_conv2d = deform_conv2d_ref
        try:
            sr_plain = vsr32(win)
        finally:
            edvr_module.deform_conv2d = kernel_fn
    d_ref = float((sr_kernel - sr_plain).abs().max())
    print(f"[main] EDVR one window, kernels vs plain DCN (fp32): max |SR diff| {d_ref:.3e} "
          "(limit 1e-3)")
    check(d_ref <= 1e-3, f"EDVR with kernels differs from the plain DCN by {d_ref}")

    profiles, calls = {}, {}
    for dt_name, model in (("fp32", vsr32), ("bf16", vsr16)):
        profiles[dt_name] = results[f"{dt_name}-windows"]["profile"] = profile_clip(
            lambda: clip(model, seq=False), f"{dt_name}-windows", smi)
        calls[dt_name] = record_dcn_calls(lambda: clip(model, seq=False))
        print(f"[main] {dt_name}-windows DCN calls per clip: "
              f"{ {k: v['count'] for k, v in calls[dt_name].items()} }")
    return launches, {k: {kk: vv for kk, vv in v.items() if kk != "sr"}
                      for k, v in results.items()}, profiles, calls


def record_dcn_calls(run) -> dict:
    """Run `run()` with EDVR's DCN calls recorded, by kind (inference or
    adaptation, batch x height x width): how many calls of that kind the
    run made, and the first one's inputs and, for adaptation, the gradient
    that reached its output."""
    calls = {}
    kernel_fn = edvr_module.deform_conv2d

    def recording(x, offset, mask, weight, bias=None, deformable_groups=1):
        out = kernel_fn(x, offset, mask, weight, bias, deformable_groups=deformable_groups)
        label = dcn_label("adapt" if out.requires_grad else "infer", x.shape)
        rec = calls.get(label)
        if rec is None:
            rec = calls[label] = dict(count=0, gd=deformable_groups, args=[
                None if t is None else t.detach().clone()
                for t in (x, offset, mask, weight, bias)])
            if out.requires_grad:
                out.register_hook(lambda g: rec.__setitem__("cot", g.detach().clone()))
        rec["count"] += 1
        return out

    edvr_module.deform_conv2d = recording
    try:
        run()
    finally:
        edvr_module.deform_conv2d = kernel_fn
    return calls


# ---------------------------------------------------------------- phase 5
def phase_timing(calls: dict, profiles: dict, smi: str) -> list:
    """Each kernel on every kind of DCN call the main path made, checked
    against the plain version and timed; per clip, the timed launches times
    their count beside the profiler's device time of the same kernels."""
    print(f"[timing] on {smi}; roofline shares against the published H100 SXM peaks "
          "(3.35 TB/s; 67 TFLOP/s fp32, 989 TFLOP/s bf16, at 700 W); times are the "
          "wrappers' (zero-fills, weight layout and casts included)")
    rows = []
    for dt_name, by_kind in calls.items():
        per_clip = dict.fromkeys(KERNELS, 0.0)
        for label, rec in by_kind.items():
            check(label.startswith("infer") or "cot" in rec, f"{label}: no gradient recorded")
            for row in against_plain(label, *rec["args"], rec.get("cot"), rec["gd"],
                                     timed=True):
                row["per_clip"] = rec["count"]
                per_clip[row["name"]] += row["ms"] * rec["count"]
                rows.append(row)
        prof = profiles.get(dt_name, {})
        print(f"[timing] {dt_name}-windows per clip: timed launches x calls "
              f"{ {k: round(v, 2) for k, v in per_clip.items()} } ms; profiler's kernel "
              f"time {prof.get('dcn_ms', 'not measured')} ms over "
              f"{prof.get('dcn_n', 'not measured')} launches")
    return rows


def profile_clip(run, mode: str, smi: str) -> dict:
    """One clip under torch.profiler: device time by kernel, the DCN
    kernels' share, and the device's idle share of the profiled wall time
    (1 - union of kernel intervals / wall; the profiler's own overhead
    lengthens the wall time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, n_by_name = [], {}, {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):  # kernels and copies
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
    if not spans:
        print(f"[profile] {mode}: the profiler recorded no device events (not measured)")
        return {}
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(by_name.values())
    dcn_us = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n) for k in KERNELS}
    dcn_n = {k: sum(v for n, v in n_by_name.items() if f"{k}_kernel" in n) for k in KERNELS}
    print(f"[profile] {mode}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {1 - busy / wall_us:.1%}; DCN kernels "
          f"{ {k: round(v / 1e3, 2) for k, v in dcn_us.items()} } ms = "
          f"{sum(dcn_us.values()) / total:.1%} of device time  [{smi}]")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        print(f"[profile] {mode}:   {us / 1e3:8.2f} ms {us / total:6.1%}  {name[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                dcn_ms={k: round(v / 1e3, 3) for k, v in dcn_us.items()}, dcn_n=dcn_n,
                top=[(n, us / 1e3) for n, us in top])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    phase_kernels()
    launches, main_results, profiles, calls = phase_main(smi)
    rows = phase_timing(calls, profiles, smi)

    kernels = []
    for name, (source, label) in KERNELS.items():
        row = next(r for r in rows if r["name"] == name and r["label"] == label
                   and r["dtype"] == "float32")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": REPLACES, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": rows, "main": main_results}, f, indent=1)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
