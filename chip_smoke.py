#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dynavsr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases; any failure raises and exits non-zero:
  1. device   the card's name, count, and nvidia-smi's name and power limit
              (no card: exit 2, no result printed);
  2. build    nvcc builds the kernels K1-K7 from csrc/ (one process per
              source, in parallel) and prints ptxas' register/smem lines;
              checks with cuobjdump that the code of K1 and of K2/K3 holds
              tensor-core (HMMA) instructions: their bf16 products run on
              mma.sync;
  3. kernels  K1 dcn_fwd, K2 dcn_bwd_data and K3 dcn_bwd_weight against the
              plain PyTorch version (ops/dcn_ref.py and its autograd) at
              Gd 8, 2, 1 in fp32 and bf16, at the main path's two L1 DCN
              shapes (inference: 40 frames of 144x176; adaptation: 40 SLR
              frames of 36x44; C = Cout = 64), on white-noise offsets that
              reach outside the image; K1-K3 in bf16 also against the
              plain version with bf16 columns and weights (their own
              function);
              K4 warp_fwd and K5 warp_bwd (grad
              flow and grad x) against ops/grid_sample_ref.py at one
              adaptation shape (8 frames of 144x176) and one inference
              shape (8 of 576x704), on white-noise flows N(0, 4^2) px;
              K6 duf_fwd and K7 duf_bwd (grad filters, and grad x on
              request) against ops/duf_filter_ref.py at DUF's adaptation
              shape (8 SLR windows of 36x44) and inference shape (8
              windows of 144x176), R = 16, fp32 and bf16 filters, both
              softmaxed and raw N(0, 1) filters (correctness checks, not
              timed);
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
  5. TOF      the DynaVSR-TOF loop at full width (TOFlow, 7 frames, the
              bicubic x4 pre-upscale; MFDN nf 64; train_ema BatchNorm
              adaptation) on the same clip through run_clip,
              window-batched, fp32 and bf16. Checks finite losses, the K4 /
              K5 launches a clip must make, the meta model's running
              statistics unchanged, and one window of TOF with the kernels
              against TOF with the plain warp; then one clip per dtype under
              torch.profiler and one whose warp calls are recorded;
  6. DUF      the DynaVSR-DUF loop at full DUF-16L width (7 frames, 64-ch
              stem, growth 32, 3 + 3 dense layers, 256/512-ch heads; MFDN
              nf 64; train_ema BatchNorm adaptation) on the same clip with
              LR = the port's duf_downsample(HR), through run_clip,
              window-batched, fp32 and bf16. Checks finite losses, K6 = 7
              and K7 = 5 launches a clip and none of K1-K5, the meta
              model's running statistics unchanged, and one window of DUF
              with the kernels against DUF with the plain filter; scores
              with crop 8 (DUF's convention); then one clip per dtype
              under torch.profiler and one whose filter calls are recorded;
  7. timing   each kernel, checked again and timed with CUDA events on the
              inputs the main paths gave it (every distinct DCN call of a
              window-batched EDVR clip: offsets, masks and gradients from the
              network itself; every distinct warp call of a TOF clip: flows
              from SpyNet, gradients from the adaptation loss; every
              distinct filter call of a DUF clip: filters from the head,
              gradients from the adaptation loss), beside the plain version
              and, for K4 / K5, F.grid_sample, for K6 / K7 the nearest
              library composite (F.unfold + einsum: two calls, so no
              library_ms); their sum over a clip's launches is set beside
              the profiler's device time for the same kernels. K4-K7 are
              also timed apart from their wrappers (kernel_times.py's
              helpers): `kernel_ms`, one launch's device time from a CUDA
              graph of 20 wrapper calls, `host_us`, one wrapper call's host
              time, and `kernel_roofline` = bound / kernel_ms; the profile
              splits their device time per clip by call size.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import torch.nn.functional as F

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
from dynavsr_tpu_torch.cli.test_dynavsr import build_mfdn, run_clip
from dynavsr_tpu_torch.data.degradations import duf_downsample
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import score_frames
from dynavsr_tpu_torch.models import duf as duf_module
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.models import tof as tof_module
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.ops import _build, dcn, duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref
from kernel_times import REPS, graph_ms, host_us
from kernel_times import event_ms as cuda_ms

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

# The DynaVSR-TOF path: TOFlow on 7 frames pre-upscaled x4, so SpyNet's
# finest level and the final warp run at 144x176 in adaptation (8 SLR
# windows of 36x44) and at 576x704 in inference (chunks of 8 windows).
TOF_G = {"which_model_G": "TOF", "nframes": 7}
TOF_FRAMES, SPY_LEVELS = 7, 4
WARP_ADAPT, WARP_INFER = (8, 3, LR_H, LR_W), (8, 3, LR_H * SCALE, LR_W * SCALE)


def warp_label(kind: str, shape) -> str:
    return f"{kind} {shape[0]}x{shape[2]}x{shape[3]}"


WARP_SHAPES = {warp_label("adapt", WARP_ADAPT): WARP_ADAPT,
               warp_label("infer", WARP_INFER): WARP_INFER}

# The DynaVSR-DUF path (configs/test/test_DUF_Vid4.yml's network, 7 frames):
# the filter runs on the centre frame, 8 SLR windows of 36x44 in
# adaptation and chunks of 8 windows of 144x176 in inference, R = 16.
DUF_G = {"which_model_G": "DUF_16L", "nframes": 7}
DUF_FRAMES, DUF_CROP, DUF_R = 7, 8, SCALE * SCALE
DUF_ADAPT, DUF_INFER = (8, 3, LR_H // 4, LR_W // 4), (8, 3, LR_H, LR_W)
DUF_SHAPES = {warp_label("adapt", DUF_ADAPT): DUF_ADAPT,
              warp_label("infer", DUF_INFER): DUF_INFER}
# name: (source, the call whose timing stands in the JSON line, the TPU kernel it replaces)
KERNELS = {
    "dcn_fwd": ("dynavsr_tpu_torch/csrc/dcn_fwd.cu", dcn_label("infer", INFER_L1),
                "dynavsr_tpu/ops/dcn_fused.py:100"),
    "dcn_bwd_data": ("dynavsr_tpu_torch/csrc/dcn_bwd.cu", dcn_label("adapt", ADAPT_L1),
                     "dynavsr_tpu/ops/dcn_fused.py:100"),
    "dcn_bwd_weight": ("dynavsr_tpu_torch/csrc/dcn_bwd.cu", dcn_label("adapt", ADAPT_L1),
                       "dynavsr_tpu/ops/dcn_fused.py:100"),
    "warp_fwd": ("dynavsr_tpu_torch/csrc/warp_fwd.cu", warp_label("infer", WARP_INFER),
                 "dynavsr_tpu/ops/grid_sample.py:54"),
    "warp_bwd": ("dynavsr_tpu_torch/csrc/warp_bwd.cu", warp_label("adapt", WARP_ADAPT),
                 "dynavsr_tpu/ops/grid_sample.py:54"),
    "duf_fwd": ("dynavsr_tpu_torch/csrc/duf_fwd.cu", warp_label("infer", DUF_INFER),
                "dynavsr_tpu/models/duf.py:47"),
    "duf_bwd": ("dynavsr_tpu_torch/csrc/duf_bwd.cu", warp_label("adapt", DUF_ADAPT),
                "dynavsr_tpu/models/duf.py:47"),
}
DCN_KERNELS = ("dcn_fwd", "dcn_bwd_data", "dcn_bwd_weight")
# Device kernels a wrapper launches besides `<name>_kernel`, counted in its
# profiled time (not in its launches): K1's channels-last copy of x; K2's
# zero-fill of its grad x scratch and the transpose to NCHW; K3's zero-fill
# of its scratch and the write-out as OIHW.
PROLOGUES = {"dcn_fwd": ("fwd::to_channels_last",),
             "dcn_bwd_data": ("bwd::gx_zero", "bwd::gx_to_nchw"),
             "dcn_bwd_weight": ("bwd::gw_zero", "bwd::gw_to_oihw")}
WARP_KERNELS = ("warp_fwd", "warp_bwd")
DUF_KERNELS = ("duf_fwd", "duf_bwd")
# The K4-K7 wrappers by module: the profile splits their time by call size.
SIZED = {"warp_fwd": warp, "warp_bwd": warp, "duf_fwd": duf_filter, "duf_bwd": duf_filter}


def reset_all_counts() -> None:
    dcn.reset_launch_counts()
    warp.reset_launch_counts()
    duf_filter.reset_launch_counts()


def all_counts() -> dict:
    return {**dcn.launch_counts(), **warp.launch_counts(), **duf_filter.launch_counts()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def wrapper_times(launch, bound_ms: float) -> dict:
    """A K4-K7 wrapper call's times: `ms`, CUDA events around 20 calls (the
    number the earlier rows hold; for a call of a few us it is the host's);
    `kernel_ms`, one launch's device time from a CUDA graph of 20 calls
    (whose last output is checked after a replay); `host_us`, one call's
    host time; and both roofline shares of `bound_ms`."""
    ms, kernel_ms = cuda_ms(launch, reps=REPS), graph_ms(launch)[0]
    return dict(ms=ms, kernel_ms=kernel_ms, host_us=host_us(launch), roofline=bound_ms / ms,
                kernel_roofline=bound_ms / kernel_ms)


def times_text(row: dict) -> str:
    return (f"{row['ms']:.4f} ms (kernel {row['kernel_ms']:.4f} ms, host "
            f"{row['host_us']:.1f} us a call)")


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
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name in ("dcn_fwd", "dcn_bwd"):
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(name))], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        hmma = [ln.split() for ln in sass.splitlines() if "HMMA" in ln]
        kinds = sorted({w for words in hmma for w in words if w.startswith("HMMA")})
        print(f"[build] {name}: {len(hmma)} tensor-core instructions in its SASS {kinds}")
        check(len(hmma) > 0,
              f"{name}'s bf16 products do not run on the tensor cores (no HMMA in SASS)")


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
    arithmetic, another order; K2/K3 atomics), bf16 2^-7 (K1's and K3's
    bf16 columns and one rounding of the kernels' fp32 result to bf16, with
    margin). In bf16 each is also held against the plain version with bf16
    columns and weights, its own function: K1 2^-8 (summation order and the
    final rounding), K2 and K3 2^-8 + 1e-4 (the final rounding, and the
    fp32 tolerance for the order in which their atomics sum). K2 and K3
    read x channels-last, as the autograd hands them K1's copy."""
    names = list(DCN_KERNELS) if cot is not None else ["dcn_fwd"]
    dtype, shape = x.dtype, tuple(x.shape)
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    ref_in = [t.detach().float().requires_grad_() for t in (x, offset, mask, weight, bias)]
    ref = deform_conv2d_ref(*ref_in, deformable_groups=gd)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got = {"dcn_fwd": [dcn.dcn_fwd(x, offset, mask, weight, bias, gd)]}
    want = {"dcn_fwd": [ref]}
    want16 = {}
    if dtype == torch.bfloat16:
        in16 = [t.detach().float().requires_grad_() for t in (x, offset, mask, weight, bias)]
        ref16 = deform_conv2d_ref(*in16, deformable_groups=gd, compute_dtype=torch.bfloat16)
        want16["dcn_fwd"] = [ref16.detach()]
    if cot is not None:
        ref_grads = torch.autograd.grad(ref, ref_in[:4], cot.float(), retain_graph=True)
        got["dcn_bwd_data"] = list(dcn.dcn_bwd_data(x_cl, offset, mask, weight, cot, gd))
        got["dcn_bwd_weight"] = [dcn.dcn_bwd_weight(x_cl, offset, mask, cot, gd)]
        want["dcn_bwd_data"], want["dcn_bwd_weight"] = list(ref_grads[:3]), [ref_grads[3]]
        if dtype == torch.bfloat16:
            grads16 = torch.autograd.grad(ref16, in16[:4], cot.float())
            want16["dcn_bwd_data"], want16["dcn_bwd_weight"] = list(grads16[:3]), [grads16[3]]
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
        "dcn_bwd_data": lambda: dcn.dcn_bwd_data(x_cl, offset, mask, weight, cot, gd),
        "dcn_bwd_weight": lambda: dcn.dcn_bwd_weight(x_cl, offset, mask, cot, gd),
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
        if dtype == torch.bfloat16:
            err16 = max(float((g.float() - r).abs().max())
                        for g, r in zip(got[name], want16[name]))
            tol16 = ((2.0 ** -8 if name == "dcn_fwd" else 2.0 ** -8 + 1e-4)
                     * max(float(r.abs().max()) for r in want16[name]))
            ok = ok and err16 <= tol16
            row.update(max_abs_err_plain_bf16=err16, tol_plain_bf16=tol16)
            line += (f"; vs plain bf16 columns {err16:.3e} (tol {tol16:.3e}) "
                     f"{'ok' if err16 <= tol16 else 'FAIL'}")
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
        check(ok, f"{name} {label} {shape} Gd={gd} {dtype}: {line}")
        rows.append(row)
    return rows


def warp_bound(name, shape, need_x):
    """(bound_ms, bound_by, bytes, flops) of one K4 / K5 call on fp32 (B, C,
    H, W) frames and (B, 2, H, W) flows: each input read once, each output
    written once. K4 reads x and the flow and writes out (2C + 2 values a
    pixel); K5 reads x, the flow and grad_out and writes grad flow, and
    grad x when asked for (2C + 4 + [C]). Operations: ~10 a pixel for the
    position and corner weights, then 7 (K4) or 12 (K5, +8 with grad x) a
    channel."""
    b, c, h, w = shape
    px = b * h * w
    if name == "warp_fwd":
        vals, flops = 2 * c + 2, px * (10 + 7 * c)
    else:
        vals = 2 * c + 4 + (c if need_x else 0)
        flops = px * (10 + (20 if need_x else 12) * c)
    nbytes = px * vals * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def torch_grid(flow):
    """The F.grid_sample grid (align_corners=True) of a (B, 2, H, W) flow:
    pixel positions normalised as 2 v / (size - 1) - 1."""
    h, w = flow.shape[-2:]
    vy, vx = grid_sample_ref.flow_grid(flow)
    return torch.stack((2.0 * vx / max(w - 1, 1) - 1.0, 2.0 * vy / max(h - 1, 1) - 1.0), dim=3)


def warp_against_plain(label, x, flow, cot, need_x, timed):
    """Hold K4 (and K5 when a cotangent is given) against the plain version
    (ops/grid_sample_ref.py and its autograd) on the same fp32 inputs and
    raise if one disagrees: forward 1e-5 of the largest reference value
    (the same four products), grad flow and grad x 1e-4 (grad x lands with
    atomics, in another order). With `timed`, time the wrappers, the plain
    version and the library call that computes the same function
    (F.grid_sample, bilinear, zeros, align_corners=True, on a grid
    normalised beforehand; its backward asked for the same gradients)."""
    shape = tuple(x.shape)
    x_r = x.detach().clone().requires_grad_(need_x)
    f_r = flow.detach().clone().requires_grad_()
    ref = grid_sample_ref.warp_nchw(x_r, f_r)
    got = {"warp_fwd": [warp.warp_fwd(x, flow)]}
    want = {"warp_fwd": [ref.detach()]}
    wrt = [f_r, x_r] if need_x else [f_r]
    if cot is not None:
        gx, gf = warp.warp_bwd(x, flow, cot, need_x=need_x)
        got["warp_bwd"] = [gf] + ([gx] if need_x else [])
        want["warp_bwd"] = list(torch.autograd.grad(ref, wrt, cot, retain_graph=True))
    torch.cuda.synchronize()
    rows = []
    for name in got:
        tol = 1e-5 if name == "warp_fwd" else 1e-4
        err = max(float((g - r).abs().max()) for g, r in zip(got[name], want[name]))
        scale = max(float(r.abs().max()) for r in want[name])
        ok = err <= tol * scale
        row = dict(name=name, label=label, dims=list(shape), dtype="float32", need_x=need_x,
                   max_abs_err=err, tol=tol * scale)
        what = "fp32 +grad x" if need_x and name == "warp_bwd" else "fp32"
        line = (f"{name:14s} {label} {shape} {what} max|err| {err:.3e} "
                f"(tol {tol * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if timed:
            grid = torch_grid(flow).requires_grad_()
            x_l = x.detach().clone().requires_grad_(need_x)
            lib = F.grid_sample(x_l, grid, mode="bilinear", padding_mode="zeros",
                                align_corners=True)
            if name == "warp_fwd":
                launch = lambda: warp.warp_fwd(x, flow)  # noqa: E731
                plain_ms = cuda_ms(lambda: grid_sample_ref.warp_nchw(x, flow), reps=5)
                library_ms = cuda_ms(lambda: F.grid_sample(
                    x, grid.detach(), mode="bilinear", padding_mode="zeros",
                    align_corners=True), reps=20)
            else:
                lib_wrt = [grid, x_l] if need_x else [grid]
                launch = lambda: warp.warp_bwd(x, flow, cot, need_x=need_x)  # noqa: E731
                plain_ms = cuda_ms(lambda: torch.autograd.grad(ref, wrt, cot, retain_graph=True),
                                   reps=5)
                library_ms = cuda_ms(lambda: torch.autograd.grad(lib, lib_wrt, cot,
                                                                 retain_graph=True), reps=20)
            check(not need_x, "the timed K5 computes grad flow only, as on TOF's path")
            bound_ms, bound_by, nbytes, flops = warp_bound(name, shape, need_x)
            row.update(library_ms=library_ms, **wrapper_times(launch, bound_ms),
                       plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                       flops=flops)
            row.update(gb_per_s=nbytes / row["ms"] / 1e6)
            line += (f"  {times_text(row)}  plain {plain_ms:.4f} ms  F.grid_sample "
                     f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}: "
                     f"{nbytes / 1e6:.2f} MB)  {row['gb_per_s']:.0f} GB/s  "
                     f"roofline {row['roofline']:.1%} (kernel {row['kernel_roofline']:.1%})")
        print(f"[{'timing' if timed else 'kernel'}] {line}")
        check(ok, f"{name} {label} {shape}: {err} > {tol * scale}")
        rows.append(row)
    return rows


def duf_bound(shape, r, fdtype):
    """(bound_ms, bound_by, bytes, flops) of one K6 call, or one K7 call for
    grad filters only, on fp32 (B, C, H, W) x and (B, 25, R, H, W) filters:
    each input read once, each output written once. Both move the same
    bytes: K6 reads x and the filters and writes C R planes, K7 reads x and
    the gradient (C R planes) and writes grad filters. Operations: the
    25-tap sum, 2 B H W C R 25, fp32."""
    b, c, h, w = shape
    px, fe = b * h * w, torch.finfo(fdtype).bits // 8
    nbytes = px * c * 4 + px * 25 * r * fe + px * c * r * 4
    flops = 2 * px * c * r * 25
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def duf_composite(name, x, f, cot):
    """The nearest library composite of K6 / K7 (F.unfold + torch.einsum;
    two calls, plus a cast of bf16 filters): the forward, or grad filters."""
    b, c, h, w = x.shape
    r = f.shape[2]
    patches = F.unfold(x, 5, padding=2).view(b, c, 25, h, w)
    if name == "duf_fwd":
        return torch.einsum("bckhw,bkrhw->bcrhw", patches, f.float()).reshape(b, c * r, h, w)
    return torch.einsum("bckhw,bcrhw->bkrhw", patches, cot.view(b, c, r, h, w)).to(f.dtype)


def duf_against_plain(label, x, f, cot, need_x, timed):
    """Hold K6 (and K7 when a cotangent is given) against the plain version
    (ops/duf_filter_ref.py and its autograd) on the same inputs and raise if
    one disagrees: 1e-5 of the largest reference value (fp32 sums in
    another order); bf16 filters' gradients are rounded to bf16 on both
    sides, so there each value may also be one bf16 step (2^-7 of it) off.
    With `timed`, time the wrappers, the plain version and the library
    composite (checked to agree as well)."""
    shape, fdtype = tuple(x.shape), f.dtype
    x_r = x.detach().clone().requires_grad_(need_x)
    f_r = f.detach().clone().requires_grad_()
    ref = dynamic_upsampling_filter_ref(x_r, f_r)
    got = {"duf_fwd": [duf_filter.duf_fwd(x, f)]}
    want = {"duf_fwd": [ref.detach()]}
    wrt = [f_r, x_r] if need_x else [f_r]
    if cot is not None:
        gx, gf = duf_filter.duf_bwd(x, f, cot, need_x=need_x)
        got["duf_bwd"] = [gf] + ([gx] if need_x else [])
        want["duf_bwd"] = list(torch.autograd.grad(ref, wrt, cot, retain_graph=True))
    torch.cuda.synchronize()

    def within(g, r):
        """(max |g - r|, every value within tolerance, max |r|)."""
        rtol = 2 ** -7 if g.dtype == torch.bfloat16 else 0.0  # one bf16 step
        scale = float(r.float().abs().max())
        d = (g.float() - r.float()).abs()
        return float(d.max()), bool((d <= rtol * r.float().abs() + 1e-5 * scale).all()), scale

    rows = []
    for name in got:
        res = [within(g, r) for g, r in zip(got[name], want[name])]
        err, ok, scale = max(v[0] for v in res), all(v[1] for v in res), max(v[2] for v in res)
        row = dict(name=name, label=label, dims=list(shape), r=f.shape[2],
                   dtype=str(fdtype).replace("torch.", ""), need_x=need_x, max_abs_err=err,
                   tol=1e-5 * scale)
        what = f"{row['dtype']} filters{' +grad x' if need_x and name == 'duf_bwd' else ''}"
        step = " + 2^-7 |ref|" if got[name][0].dtype == torch.bfloat16 else ""
        line = (f"{name:14s} {label} {shape} R={f.shape[2]} {what} max|err| {err:.3e} "
                f"(tol {1e-5 * scale:.3e}{step}) {'ok' if ok else 'FAIL'}")
        if timed:
            comp = duf_composite(name, x, f, cot)
            comp_err, comp_ok, _ = within(comp, want[name][0])
            check(comp_ok, f"{name} {label}: the unfold + einsum composite differs by {comp_err}")
            if name == "duf_fwd":
                launch = lambda: duf_filter.duf_fwd(x, f)  # noqa: E731
                plain_ms = cuda_ms(lambda: dynamic_upsampling_filter_ref(x, f), reps=5)
            else:
                launch = lambda: duf_filter.duf_bwd(x, f, cot, need_x=need_x)  # noqa: E731
                plain_ms = cuda_ms(lambda: torch.autograd.grad(ref, wrt, cot, retain_graph=True),
                                   reps=5)
            composite_ms = cuda_ms(lambda: duf_composite(name, x, f, cot), reps=20)
            check(not need_x, "the timed K7 computes grad filters only, as on DUF's path")
            bound_ms, bound_by, nbytes, flops = duf_bound(shape, f.shape[2], fdtype)
            row.update(library_ms=None, **wrapper_times(launch, bound_ms),
                       plain_ms=plain_ms, composite_ms=composite_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, flops=flops)
            row.update(gb_per_s=nbytes / row["ms"] / 1e6)
            line += (f"  {times_text(row)}  plain {plain_ms:.4f} ms  library none (one call); "
                     f"unfold+einsum {composite_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by}: "
                     f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)  "
                     f"{row['gb_per_s']:.0f} GB/s  roofline {row['roofline']:.1%} "
                     f"(kernel {row['kernel_roofline']:.1%})")
        print(f"[{'timing' if timed else 'kernel'}] {line}")
        check(ok, f"{name} {label} {shape} {fdtype}: {err} > tolerance")
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
    for label, shape in WARP_SHAPES.items():
        x = torch.randn(*shape, generator=gen, device="cuda")
        flow = torch.randn(shape[0], 2, *shape[2:], generator=gen, device="cuda") * 4.0
        cot = torch.randn(*shape, generator=gen, device="cuda")
        warp_against_plain(label, x, flow, cot, need_x=True, timed=False)
        del x, flow, cot
        torch.cuda.empty_cache()
    for label, (b, c, h, w) in DUF_SHAPES.items():
        for fdtype in (torch.float32, torch.bfloat16):
            for kind in ("softmax", "raw"):
                x = torch.rand(b, c, h, w, generator=gen, device="cuda")
                f = torch.randn(b, 25, DUF_R, h, w, generator=gen, device="cuda")
                f = (torch.softmax(f, dim=1) if kind == "softmax" else f).to(fdtype)
                cot = torch.randn(b, c * DUF_R, h, w, generator=gen, device="cuda")
                duf_against_plain(f"{label} {kind}", x, f, cot, need_x=True, timed=False)
                del x, f, cot
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4
def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights: U(+-1/sqrt(fan_in)) like torch's default conv init,
    scaled by 0.1 in residual blocks (the reference's initialize_weights).
    BatchNorm keeps torch's defaults: weight 1, bias 0, running stats 0 / 1."""
    bn = {f"{m}.{n}" for m, mod in model.named_modules()
          if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)
          for n, _ in mod.named_parameters(recurse=False)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name in bn:
                continue
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


def phase_main(smi: str, gen: torch.Generator, lq: np.ndarray, gt: np.ndarray):
    vsr32 = define_G({"network_G": EDVR_M})  # the entry points' default device: the card
    init_weights(vsr32, gen)
    vsr16 = define_G({"network_G": {**EDVR_M, "dtype": "bfloat16"}})
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

    reset_all_counts()
    results = {}
    for dt_name, model in (("fp32", vsr32), ("bf16", vsr16)):
        for seq in (False, True):
            mode = f"{dt_name}-{'seq' if seq else 'windows'}"
            before = all_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            sr, res = clip(model, seq)
            secs = time.perf_counter() - t0  # run_clip returns host arrays: synchronised
            peak = torch.cuda.max_memory_allocated()
            counts = {k: v - before[k] for k, v in all_counts().items() if k in DCN_KERNELS}
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
    launches = all_counts()
    print(f"[main] launches over the four clips: {launches}")
    for name in DCN_KERNELS:
        check(launches[name] > 0, f"kernel {name} was never launched on the EDVR path")

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
            lambda: clip(model, seq=False), f"{dt_name}-windows", smi, DCN_KERNELS)
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


# ---------------------------------------------------------- phases 5, 6
def warp_launches_per_clip(cfg: AdaptConfig) -> dict:
    """K4 / K5 launches one window-batched TOF clip must make: every SpyNet
    call warps once per level, and each neighbour's frame is warped once
    more by its final flow; the level-0 flow is zeros with no gradient, so
    that warp gets no backward."""
    nbrs, chunks = TOF_FRAMES - 1, -(-CLIP_T // cfg.infer_chunk)
    per_forward = nbrs * (SPY_LEVELS + 1)
    return {"warp_fwd": (cfg.n_steps + chunks) * per_forward,
            "warp_bwd": cfg.n_steps * nbrs * SPY_LEVELS}


def duf_launches_per_clip(cfg: AdaptConfig) -> dict:
    """K6 / K7 launches one window-batched DUF clip must make: one filter
    per forward (each adaptation step and each inference chunk), one
    backward per adaptation step."""
    chunks = -(-CLIP_T // cfg.infer_chunk)
    return {"duf_fwd": cfg.n_steps + chunks, "duf_bwd": cfg.n_steps}


def phase_bn_net(tag: str, net_g: dict, frames: int, kernels, expect_fn, swap, smi: str,
                 gen: torch.Generator, lq: np.ndarray, gt: np.ndarray, padding: str,
                 crop: int):
    """The DynaVSR loop for a BatchNorm backbone (TOF, DUF) at full width,
    fp32 and bf16, window-batched, through run_clip. `kernels` are the
    path's own, `expect_fn(cfg)` their launches a clip; `swap` = (module,
    attribute, plain function) is the op that the one-window check runs
    both through the kernels and through the plain version."""
    opt = {"scale": SCALE, "network_G": net_g}
    net32 = define_G(opt)  # the entry points' default device: the card
    init_weights(net32, gen)
    net16 = define_G({**opt, "network_G": {**net_g, "dtype": "bfloat16"}})
    net16.load_state_dict(net32.state_dict())
    est = build_mfdn({"nf": MFDN_NF}, SCALE, frames)
    init_weights(est, gen)
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    expect = expect_fn(cfg)
    stats0 = {k: v.clone() for k, v in net32.state_dict().items() if "running" in k}

    def clip(model):
        return run_clip(model, est, lq, None, cfg, seq=False, n_frames=frames,
                        padding=padding, n_adapt=N_WINDOWS)

    for model in (net32, net16):  # warm-up: cuDNN plans, kernel loads
        clip(model)

    results, launches = {}, {}
    for dt_name, model in (("fp32", net32), ("bf16", net16)):
        mode = f"{tag}-{dt_name}-windows"
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sr, res = clip(model)
        secs = time.perf_counter() - t0  # run_clip returns host arrays: synchronised
        counts = all_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = res["adapt_losses"]
        check(len(losses) == 5 and all(math.isfinite(v) for v in losses),
              f"{mode}: adaptation losses {losses}")
        check(sr.shape == gt.shape and bool(np.isfinite(sr).all()), f"{mode}: SR output")
        for name in kernels:
            check(counts[name] == expect[name],
                  f"{mode}: {name} launched {counts[name]} times, a clip makes {expect[name]}")
        for name in set(counts) - set(kernels):
            check(counts[name] == 0, f"{mode}: {tag} launched {name}")
        if dt_name == "fp32":
            launches = counts
        score = score_frames(sr, gt, ycbcr=True, crop_border=crop)
        results[mode] = dict(fps=CLIP_T / secs, secs=secs, peak=peak, losses=losses,
                             counts=counts, psnr=score["psnr_avg"], ssim=score["ssim_avg"])
        print(f"[{tag}] {mode:18s} {CLIP_T / secs:.3f} frames/s ({secs:.3f} s/clip) "
              f"peak {peak / 2**30:.2f} GiB  PSNR-Y {score['psnr_avg']:.3f} "
              f"SSIM {score['ssim_avg']:.4f} (crop {crop})  "
              f"losses {[f'{v:.6f}' for v in losses]}  "
              f"launches {({k: counts[k] for k in kernels})} (a clip makes {expect})  [{smi}]")
    for k, v in net32.state_dict().items():
        if k in stats0:
            check(torch.equal(v, stats0[k]), f"the meta model's {k} moved: the copy leaked")
    print(f"[{tag}] the meta model's BatchNorm running statistics are unchanged after the clips")

    # One window through the net with the kernels and with the plain op.
    win = torch.as_tensor(lq[all_windows(CLIP_T, frames, padding)[:1]], device="cuda")
    apply = make_model_apply(net32.arch, SCALE)
    module, attr, plain_fn = swap
    kernel_fn = getattr(module, attr)
    with torch.no_grad():
        sr_kernel = apply(net32, win)
        setattr(module, attr, plain_fn)
        try:
            sr_plain = apply(net32, win)
        finally:
            setattr(module, attr, kernel_fn)
    d_ref = float((sr_kernel - sr_plain).abs().max())
    print(f"[{tag}] one window, kernels vs plain {attr} (fp32): max |SR diff| {d_ref:.3e} "
          "(limit 1e-4)")
    check(d_ref <= 1e-4, f"{tag} with the kernels differs from the plain {attr} by {d_ref}")

    profiles, calls = {}, {}
    for dt_name, model in (("fp32", net32), ("bf16", net16)):
        mode = f"{tag}-{dt_name}-windows"
        profiles[dt_name] = results[mode]["profile"] = profile_clip(
            lambda: clip(model), mode, smi, kernels)
        calls[dt_name] = record_calls(lambda: clip(model), module, attr)
        print(f"[{tag}] {mode} {attr} calls per clip: "
              f"{ {k: (v['count'], v['bwd']) for k, v in calls[dt_name].items()} } "
              "(kind BxHxW: (forward, backward))")
    return launches, results, profiles, calls


def record_calls(run, module, attr: str) -> dict:
    """Run `run()` with the calls of `module.attr(x, second)` recorded (the
    TOF warp, the DUF filter), by kind (adaptation when autograd is on, else
    inference) and batch x height x width of x: how many calls of that kind
    the run made and how many of them had a backward, the first one's
    inputs and, where it had one, the gradient that reached its output."""
    calls = {}
    kernel_fn = getattr(module, attr)

    def recording(x, second):
        out = kernel_fn(x, second)
        label = warp_label("adapt" if torch.is_grad_enabled() else "infer", x.shape)
        rec = calls.get(label)
        if rec is None:
            rec = calls[label] = dict(count=0, bwd=0, args=[x.detach().clone(),
                                                            second.detach().clone()])
        rec["count"] += 1
        if out.requires_grad:
            rec["bwd"] += 1
            if "cot" not in rec:
                rec["cot"] = None
                out.register_hook(lambda g: rec.__setitem__("cot", g.detach().clone()))
        return out

    setattr(module, attr, recording)
    try:
        run()
    finally:
        setattr(module, attr, kernel_fn)
    return calls


# ---------------------------------------------------------------- phase 7
def phase_timing(calls: dict, profiles: dict, smi: str) -> list:
    """Each kernel on every kind of DCN call the main path made, checked
    against the plain version and timed; per clip, the timed launches times
    their count beside the profiler's device time of the same kernels."""
    print(f"[timing] on {smi}; roofline shares against the published H100 SXM peaks "
          "(3.35 TB/s; 67 TFLOP/s fp32, 989 TFLOP/s bf16, at 700 W); times are the "
          "wrappers' (zero-fills, weight layout and casts included)")
    rows = []
    for dt_name, by_kind in calls.items():
        per_clip = dict.fromkeys(DCN_KERNELS, 0.0)
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
              f"time {prof.get('kernel_ms', 'not measured')} ms over "
              f"{prof.get('kernel_n', 'not measured')} launches")
    return rows


def phase_recorded_timing(tag: str, calls: dict, profiles: dict, kernels, against) -> list:
    """The path's forward and backward kernels (`kernels`) on every kind of
    call a TOF or DUF clip made, checked against the plain version by
    `against` and timed beside it; per clip, the timed launches times their
    count beside the profiler's device time."""
    rows = []
    fwd, _ = kernels
    for dt_name, by_kind in calls.items():
        per_clip = dict.fromkeys(kernels, 0.0)
        per_clip_kernel = dict.fromkeys(kernels, 0.0)
        for label, rec in sorted(by_kind.items()):
            check(rec["bwd"] == 0 or rec.get("cot") is not None,
                  f"{label}: no gradient recorded")
            for row in against(label, *rec["args"], rec.get("cot"), need_x=False, timed=True):
                row["per_clip"] = rec["count"] if row["name"] == fwd else rec["bwd"]
                row["run"] = dt_name
                per_clip[row["name"]] += row["ms"] * row["per_clip"]
                per_clip_kernel[row["name"]] += row["kernel_ms"] * row["per_clip"]
                rows.append(row)
        prof = profiles.get(dt_name, {})
        print(f"[timing] {tag}-{dt_name}-windows per clip: timed launches x calls "
              f"{ {k: round(v, 3) for k, v in per_clip.items()} } ms (kernel time from the "
              f"graphs { {k: round(v, 3) for k, v in per_clip_kernel.items()} } ms); "
              f"profiler's kernel time {prof.get('kernel_ms', 'not measured')} ms over "
              f"{prof.get('kernel_n', 'not measured')} launches; by call size "
              f"{prof.get('by_size', 'not measured')}")
    return rows


def profile_clip(run, mode: str, smi: str, names) -> dict:
    """One clip under torch.profiler: device time by kernel, the share of
    the port's kernels `names` (with their PROLOGUES), and the device's
    idle share of the profiled wall time (1 - union of kernel intervals /
    wall; the profiler's own overhead lengthens the wall time). The K4-K7
    among `names` are also split by call size (batch x height x width): the
    wrappers' calls are recorded in order, and their launches, all on one
    stream, run in that order."""
    from torch.profiler import ProfilerActivity, profile

    sized = [k for k in names if k in SIZED]
    sizes = {k: [] for k in sized}
    wrappers = {k: getattr(SIZED[k], k) for k in sized}

    def recording(k):
        def call(x, *args, **kwargs):
            sizes[k].append(warp_label("", x.shape).strip())
            return wrappers[k](x, *args, **kwargs)
        return call

    for k in sized:
        setattr(SIZED[k], k, recording(k))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for k in sized:
            setattr(SIZED[k], k, wrappers[k])
    spans, by_name, n_by_name = [], {}, {}
    launches = {k: [] for k in sized}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):  # kernels and copies
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
            for k in sized:
                if f"{k}_kernel" in e.name:
                    launches[k].append((e.time_range.start, e.time_range.elapsed_us()))
    if not spans:
        print(f"[profile] {mode}: the profiler recorded no device events (not measured)")
        return {}
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = sum(by_name.values())
    k_us = {k: sum(v for n, v in by_name.items()
                   if any(p in n for p in (f"{k}_kernel", *PROLOGUES.get(k, ()))))
            for k in names}
    k_n = {k: sum(v for n, v in n_by_name.items() if f"{k}_kernel" in n) for k in names}
    by_size = {}
    for k in sized:
        if len(launches[k]) != len(sizes[k]):
            by_size[k] = (f"not measured ({len(launches[k])} launches profiled, "
                          f"{len(sizes[k])} calls)")
            continue
        split = {}
        for size, (_, us) in zip(sizes[k], sorted(launches[k])):
            n, ms = split.get(size, (0, 0.0))
            split[size] = (n + 1, ms + us / 1e3)
        by_size[k] = {size: [n, round(ms, 4)] for size, (n, ms) in sorted(split.items())}
    print(f"[profile] {mode}: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms, "
          f"idle share {1 - busy / wall_us:.1%}; the port's kernels "
          f"{ {k: round(v / 1e3, 2) for k, v in k_us.items()} } ms = "
          f"{sum(k_us.values()) / total:.1%} of device time  [{smi}]")
    if by_size:
        print(f"[profile] {mode}: by call size, [launches, ms]: {by_size}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, us in top:
        print(f"[profile] {mode}:   {us / 1e3:8.2f} ms {us / total:6.1%}  {name[:90]}")
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                kernel_ms={k: round(v / 1e3, 3) for k, v in k_us.items()}, kernel_n=k_n,
                kernel_share=sum(k_us.values()) / total, by_size=by_size,
                top=[(n, us / 1e3) for n, us in top])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    args = ap.parse_args()
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    phase_kernels()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lq, gt = synthetic_clip(gen)
    edvr_launches, main_results, profiles, calls = phase_main(smi, gen, lq, gt)
    tof_launches, tof_results, tof_profiles, warp_calls = phase_bn_net(
        "tof", TOF_G, TOF_FRAMES, WARP_KERNELS, warp_launches_per_clip,
        (tof_module, "warp_nchw", grid_sample_ref.warp_nchw), smi, gen, lq, gt,
        padding="reflection", crop=0)
    with torch.no_grad():  # DUF's blur-matched LR of the same HR clip
        duf_lq = duf_downsample(torch.as_tensor(gt, device="cuda"), SCALE).cpu().numpy()
    check(duf_lq.shape == lq.shape, f"duf_downsample gave {duf_lq.shape}, not {lq.shape}")
    duf_launches, duf_results, duf_profiles, duf_calls = phase_bn_net(
        "duf", DUF_G, DUF_FRAMES, DUF_KERNELS, duf_launches_per_clip,
        (duf_module, "dynamic_upsampling_filter", dynamic_upsampling_filter_ref), smi, gen,
        duf_lq, gt, padding="new_info", crop=DUF_CROP)
    rows = phase_timing(calls, profiles, smi)
    rows += phase_recorded_timing("tof", warp_calls, tof_profiles, WARP_KERNELS,
                                  warp_against_plain)
    rows += phase_recorded_timing("duf", duf_calls, duf_profiles, DUF_KERNELS,
                                  duf_against_plain)
    # Each kernel's launches are those of the path that runs it (counts set
    # to 0 just before that path and read just after).
    launches = {**{k: edvr_launches[k] for k in DCN_KERNELS},
                **{k: tof_launches[k] for k in WARP_KERNELS},
                **{k: duf_launches[k] for k in DUF_KERNELS}}

    kernels = []
    for name, (source, label, replaces) in KERNELS.items():
        row = next(r for r in rows if r["name"] == name and r["label"] == label
                   and r["dtype"] == "float32" and r.get("run", "fp32") == "fp32")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row.get("library_ms")})
        if "kernel_ms" in row:  # K4-K7: the device time of a launch, the host's of a call
            kernels[-1].update({k: row[k] for k in ("kernel_ms", "host_us", "kernel_roofline")})
        if name in DCN_KERNELS + DUF_KERNELS:  # the bf16 call of the same kind
            r16 = next(r for r in rows if r["name"] == name and r["label"] == label
                       and r["dtype"] == "bfloat16")
            kernels[-1].update(ms_bf16=r16["ms"], bound_ms_bf16=r16["bound_ms"],
                               max_abs_err_bf16=r16["max_abs_err"])
            if "kernel_ms" in r16:
                kernels[-1].update(kernel_ms_bf16=r16["kernel_ms"], host_us_bf16=r16["host_us"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": rows, "main": main_results, "tof": tof_results,
                       "duf": duf_results, "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
