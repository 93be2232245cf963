#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dynavsr_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases; any failure raises and exits non-zero:
  1. device   the card's name, count, and nvidia-smi's name and power limit
              (no card: exit 2, no result printed);
  2. build    nvcc builds the kernels K1-K12 from csrc/ (one process per
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
              softmaxed and raw N(0, 1) filters; the K11 / K12 kernel
              (warp_tangent.cu) in each mode: T alone (warp_fwd_tangent),
              grad flow, grad flow + grad x, each gradient with T in the
              same launch (warp_bwd_tangent), against grid_sample_ref's
              *_tangent_ref at TOF's meta shapes (8 frames of 64x64 and
              256x256), white-noise flows N(0, 4^2) px and tangents
              (correctness checks, not timed);
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
              splits their device time per clip by call size;
  8. surface  the rest of the serving surface at full width, random weights
              from the seed, through the entry points' own functions on
              in-memory test sets (the card's machine has no image reader):
              8a cli/test.py's path (create_model -> make_infer_fn /
              make_seq_infer_fn -> evaluate_dataset) with
              test_EDVR_M_REDS4.yml's EDVR-M on a 10-frame 180x320 clip,
              fp32 / bf16, window-batched and eval.seq: K1 = 8 launches a
              clip, no K2 / K3, each K1 call of a windowed run against the
              plain DCN at its shape (40 and 10 frames of 180x320 and the
              pyramid's levels; phase 2's tolerances), finite PSNR, window == seq (fp32), frames/s
              (and in the forwards alone) and peak memory above what the
              earlier phases hold; 8b the Vimeo90K-T protocol
              (test_Vimeo90K.yml's 7-frame EDVR, 4 septuplets of 64x112,
              centre frames scored): K1 = 4, each call against the plain
              DCN as in 8a; 8c run_clip with an SFDN
              estimator (test_DynaVSR_SFDN_Vid4.yml) on phase 4's clip,
              fp32 / bf16: K1 = 28, K2 = K3 = 20 a clip; 8d DUF-16L with
              bn_mode grad_stats and the sgd optimizer (lr 1) on phase 6's
              clip: K6 = 7, K7 = 5, the loss falls, every running statistic
              of the adapted copy moves by at least 1e-6 and none of the
              meta model's moves; 8e EDVR-M with predeblur, HR_in (HR
              720x1280 in) and w_TSA false, one window with the kernels
              against the plain DCN (1e-3);
  9. train    supervised training through cli/train.train at EDVR-M's full
              width on REDS-shaped raw-byte LMDBs written here (4 clips
              outside REDS4 x 16 frames, GT 720x1280, LQ 180x320 from the
              port's imresize; 64 items, 2 batches of 32 an epoch): 9a
              train_EDVR_M_REDS.yml's fields (fp32, Gd 8), 8 updates; 9b
              train_EDVR_M_TPU.yml's (bf16, Gd 2, restart weights 1 / .5 /
              .5 / .5), 6 updates; each then resumed from the state saved
              at update 4. Checks: every l_pix finite and the last two
              below the first two, the offset metric 0 at update 1, K1 =
              K2 = K3 = 4 launches each update and no K4-K7, the resumed
              net and Adam moments bitwise the saved files', the resumed
              run's batch 5 bitwise the uninterrupted run's; one update of
              a trained copy with every K1-K3 call held against the plain
              DCN at phase 3's tolerances (and timed at each shape: 160
              rows of 64x64, 32x32, 16x16). Reports s/update (updates 3-N,
              the card synchronised around each), samples/s, the loader's
              wait, peak memory, and under torch.profiler over 2 updates
              the device's busy / idle share, top operations and K1-K3's
              device time an update, as a `[train] {json}` line;
 10. meta     DynaVSR's training through cli/train.train at full width:
              10a train_MFDN_Vimeo90K.yml (MFDN nf 64, batch 16 x 7 x
              256^2, l1) on a Vimeo90K-shaped raw-byte LMDB written here
              (32 septuplets of 448x256), 8 updates, resumed from update
              4; 10b train_SFDN_Vimeo90K.yml, 4 updates; an MFDN trained 2
              updates on phase 9's REDS-shaped LMDB with 5-frame windows
              (the EDVR meta config's) as network_E; 10c
              train_DynaVSR_EDVR_REDS.yml (EDVR-M, batch 8 x 5 x 256^2,
              one inner SGD step at alpha 1e-5, second order, Adam 1e-5,
              MFDN in the loop) from random weights, 6 updates, resumed
              from update 3. Checks: each run's loss on its first batch
              falls, the resumed net, Adam moments and next batch bitwise,
              K1 28, K2 24, K3 20, K8-K10 4 launches each meta update and
              none in the downscalers'. 10d: one meta update with every
              K1-K3 and K8-K10 call held against its plain version
              (1e-4 of the largest value); the second-order part of the
              meta gradient (second minus first order) with the kernels
              against the plain DCN's (relative norm 1e-2) at the first
              alpha in 1e-3..10 where it is >= 5 % of the gradient, with
              the offset convs redrawn N(0, 0.05) so samples fall off the
              pixel grid's kinks (10c's own ~1e-4 px offsets are read and
              reported too); K8-K10
              timed on the meta update's own inputs (each call size: 40
              SLR frames of 16x16, 8x8 and 4x4) with their bounds, the
              graph replays of K8 and of K10's offset and mask gradients
              checked bitwise; 2 meta updates profiled. Prints a `[meta]
              {json}` line.
 11. meta2    second-order meta-training of the BatchNorm backbones
              through cli/train.train at full width, on 10a's LMDB with
              10a's 7-frame MFDN as network_E, from random weights, 6
              updates resumed from update 3, the running statistics
              meta-trained as in JAX: 11a train_DynaVSR_TOF_Vimeo90K.yml
              (TOFlow, 7 frames, in-module x4 pre-upscale, batch 8 x 7 x
              256^2, alpha 1e-5, Adam 1e-5): K4 120, K5 72, and 24 launches
              of the K11 / K12 kernel with T and grad flow together
              (warp_bwd_tangent; none of T alone) each update; 11b train_DynaVSR_DUF_Vimeo90K.yml
              (DUF-16L, batch 4): K6 5, K7 3; neither launches K1-K3 or
              K8-K10. Checks: l_outer on the first batch falls, every
              running statistic moves, the resumed net (statistics
              included), Adam moments and next batch bitwise. 11c, each
              net: one meta update with every K4-K7, K11 / K12 call held
              against its plain version (1e-4 of the largest value); 2
              meta updates profiled; the second-order part of the meta
              gradient with the kernels against the plain op's (relative
              norm 1e-2) at the first alpha in 1e-3..10 where it is >= 5 %
              of the gradient, for TOF with SpyNet's last-conv biases
              redrawn N(0, 0.1) so the flows sit off the pixel grid (the
              trained weights' reading is reported too); the K11 / K12
              launch timed on the inputs of its largest call. 11d (TOF): over 16 draws of
              SpyNet's last-conv biases, the warp's first- and second-order
              terms on every warp call of one LR window's forward, plain
              warp and K4 / K5 / K11 / K12 in fp32 against the plain warp
              in float64, beside the share of samples on and within one
              fp32 ulp of a bilinear kink (reported, not checked). Prints a
              `[meta2] {json}` line.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

import torch.nn.functional as F

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, make_adapt_fn
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, run_clip
from dynavsr_tpu_torch.data.degradations import duf_downsample
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.data.windows import all_windows, index_generation
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.convert_img import tensor2img
from dynavsr_tpu_torch.eval.harness import evaluate_dataset, score_frames
from dynavsr_tpu_torch.eval.metrics import calculate_psnr
from dynavsr_tpu_torch.models import duf as duf_module
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.models import tof as tof_module
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.video_base_model import create_model
from dynavsr_tpu_torch.ops import _build, dcn, duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.dcn_ref import (
    dcn_bwd_data_tangent_ref,
    dcn_bwd_weight_tangent_ref,
    dcn_fwd_tangent_ref,
    deform_conv2d_ref,
)
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
# TOF's meta-training warps (train_DynaVSR_TOF_Vimeo90K.yml, 8 windows): the
# inner step's SLR pre-upscaled to 64x64, the outer LR to 256x256.
WARP_META_SHAPES = {warp_label("meta", s): s for s in ((8, 3, 64, 64), (8, 3, 256, 256))}

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
    # The second order of deform_conv2d_fused's autodiff (meta-training),
    # timed at the meta inner step's L1 call: 8 windows x 5 SLR frames of 16x16.
    "dcn_fwd_tangent": ("dynavsr_tpu_torch/csrc/dcn_tangent.cu", "meta 40x16x16",
                        "dynavsr_tpu/ops/dcn_fused.py:100"),
    "dcn_bwd_weight_tangent": ("dynavsr_tpu_torch/csrc/dcn_tangent.cu", "meta 40x16x16",
                               "dynavsr_tpu/ops/dcn_fused.py:100"),
    "dcn_bwd_data_tangent": ("dynavsr_tpu_torch/csrc/dcn_tangent.cu", "meta 40x16x16",
                             "dynavsr_tpu/ops/dcn_fused.py:100"),
    # The second order of _packed_bilinear's autodiff (TOF's meta-training):
    # K11's T and K12's gradients, one kernel and one launch, timed at its
    # largest call of a meta update (the inner step's 8 windows, SLR
    # pre-upscaled to 64x64; T and grad flow).
    "warp_bwd_tangent": ("dynavsr_tpu_torch/csrc/warp_tangent.cu", "meta 8x64x64",
                         "dynavsr_tpu/ops/grid_sample.py:54"),
}
DCN_KERNELS = ("dcn_fwd", "dcn_bwd_data", "dcn_bwd_weight")
# Device kernels a wrapper launches besides `<name>_kernel`, counted in its
# profiled time (not in its launches): K1's channels-last copy of x; K2's
# zero-fill of its grad x scratch and the transpose to NCHW; K3's zero-fill
# of its scratch and the write-out as OIHW; K8's sum of its tap splits;
# K9's write-out (its scratch is zeroed by a memset).
PROLOGUES = {"dcn_fwd": ("fwd::to_channels_last",),
             "dcn_bwd_data": ("bwd::gx_zero", "bwd::gx_to_nchw"),
             "dcn_bwd_weight": ("bwd::gw_zero", "bwd::gw_to_oihw"),
             "dcn_fwd_tangent": ("tng::sum_parts",),
             "dcn_bwd_weight_tangent": ("tng::gw_tangent_to_oihw",)}
WARP_KERNELS = ("warp_fwd", "warp_bwd")
DUF_KERNELS = ("duf_fwd", "duf_bwd")
# The K4-K7 wrappers by module: the profile splits their time by call size.
SIZED = {"warp_fwd": warp, "warp_bwd": warp, "warp_fwd_tangent": warp, "warp_bwd_tangent": warp,
         "duf_fwd": duf_filter, "duf_bwd": duf_filter}


def reset_all_counts() -> None:
    dcn.reset_launch_counts()
    warp.reset_launch_counts()
    duf_filter.reset_launch_counts()


def all_counts() -> dict:
    return {**dcn.launch_counts(), **warp.launch_counts(), **duf_filter.launch_counts()}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def wrapper_times(launch, bound_ms: float, rtol=0.0) -> dict:
    """A K4-K12 wrapper call's times: `ms`, CUDA events around 20 calls (the
    number the earlier rows hold; for a call of a few us it is the host's);
    `kernel_ms`, one launch's device time from a CUDA graph of 20 calls
    (whose last output is checked after a replay, within `rtol` where the
    kernel sums with atomics, one per output where a sequence); `host_us`,
    one call's host time; and both roofline shares of `bound_ms`."""
    ms, kernel_ms = cuda_ms(launch, reps=REPS), graph_ms(launch, rtol=rtol)[0]
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
    for label, shape in WARP_META_SHAPES.items():
        x = torch.randn(*shape, generator=gen, device="cuda")
        flow = torch.randn(shape[0], 2, *shape[2:], generator=gen, device="cuda") * 4.0
        cflow = torch.randn(shape[0], 2, *shape[2:], generator=gen, device="cuda")
        cot = torch.randn(*shape, generator=gen, device="cuda")
        warp_tangent_against_plain(label, x, flow, cflow, cot)
        del x, flow, cflow, cot
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
RES_BLOCKS = ("feature_extraction", "recon_trunk", "pre_deblur.RB_")


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
            scale = 0.1 if any(k in name for k in RES_BLOCKS) else 1.0
            p.copy_((torch.rand(p.shape, generator=gen, device=p.device) * 2 - 1)
                    * scale / math.sqrt(fan_in))


def synthetic_clip(gen: torch.Generator, frames: int = CLIP_T, lr_h: int = LR_H,
                   lr_w: int = LR_W):
    """A smooth HR clip (moving sinusoids, values in (0, 1)) of `frames`
    frames, 16 of 576x704 by default, and its LR = the port's
    MATLAB-bicubic imresize(HR, 1/4)."""
    h, w = lr_h * SCALE, lr_w * SCALE
    dev = "cuda"
    y = torch.arange(h, device=dev).view(1, h, 1, 1) / h
    x = torch.arange(w, device=dev).view(1, 1, w, 1) / w
    t = torch.arange(frames, device=dev).view(frames, 1, 1, 1)
    acc = torch.zeros(frames, h, w, 3, device=dev)
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
    est = build_estimator({"nf": MFDN_NF}, SCALE, EDVR_M["nframes"])
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
    est = build_estimator({"nf": MFDN_NF}, SCALE, frames)
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


# ---------------------------------------------------------------- phase 8
# The serving surface at the test configs' widths. 8a: test_EDVR_M_REDS4.yml's
# net on a REDS-shaped clip (10 frames of 180x320 LR, GT 720x1280); 8b:
# test_Vimeo90K.yml's net (EDVR-M, 7 frames) on Vimeo90K-T-shaped septuplets;
# 8e: the EDVR variants at EDVR-M width.
EDVR_REDS4 = {**EDVR_M, "predeblur": False, "HR_in": False}
REDS_T, REDS_H, REDS_W = 10, 180, 320
EDVR_VIMEO = {**EDVR_M, "nframes": 7}
VIMEO_N, VIMEO_H, VIMEO_W = 4, 64, 112
EVAL_CHUNK = 8  # eval.infer_chunk's default
EDVR_VARIANTS = {"predeblur": {"predeblur": True}, "HR_in": {"HR_in": True},
                 "w_TSA false": {"w_TSA": False}}


class MemoryTestSet:
    """The test sets' surface that eval/harness.evaluate_dataset reads
    (data/datasets.py: names, clip_frames, has_gt, __len__, __getitem__,
    center_only) over clips held in memory: the card's machine has no
    image reader. clips: {name: (lq (T, h, w, 3), gt or None)}."""

    def __init__(self, clips: dict, n_frames: int, padding: str, center_only: bool = False):
        self.clips, self.n_frames, self.padding = clips, n_frames, padding
        self.center_only = center_only
        self.names = list(clips)
        self.items = [(c, i, len(lq)) for c, (lq, _) in clips.items()
                      for i in ([len(lq) // 2] if center_only else range(len(lq)))]

    def has_gt(self, clip: str) -> bool:
        return self.clips[clip][1] is not None

    def clip_frames(self, clip: str, gt: bool = False) -> np.ndarray:
        return self.clips[clip][1 if gt else 0]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        clip, i, t = self.items[index]
        item = {"LQs": self.clips[clip][0][index_generation(i, t, self.n_frames, self.padding)],
                "folder": clip}
        if self.has_gt(clip):
            item["GT"] = self.clips[clip][1][i]
        return item


def recorded(fn, outs: list, secs: list):
    """fn, with each call's output and host seconds (it returns host arrays,
    so the card is synchronised) appended to outs and secs."""
    def call(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        return out
    return call


def eval_models(net_g: dict, gen: torch.Generator, extra: dict = None):
    """create_model (cli/test.py's path) for `net_g` in fp32 and bf16 on the
    card, with the same seeded weights."""
    opt = {"scale": SCALE, "network_G": net_g, "path": {},
           "eval": {"infer_chunk": EVAL_CHUNK, **(extra or {})}}
    m32 = create_model(opt)
    init_weights(m32.netG, gen)
    m16 = create_model({**opt, "network_G": {**net_g, "dtype": "bfloat16"}})
    m16.netG.load_state_dict(m32.netG.state_dict())
    return {"fp32": m32, "bf16": m16}


def check_only(counts: dict, expect: dict, what: str) -> None:
    for name, n in counts.items():
        check(n == expect.get(name, 0),
              f"{what}: {name} launched {n} times, expected {expect.get(name, 0)}")


def checked_dcn_calls(run, what: str) -> list:
    """Run `run()` with each of EDVR's DCN calls (K1, the path's own launch)
    held against the plain version on the same inputs, at against_plain's
    tolerances for K1 relative to the plain result's largest value: fp32
    1e-4; bf16 2^-7 against the fp32 plain version and 2^-8 against the
    plain version with bf16 columns and weights. Raises on the first call
    that disagrees; returns one row a call."""
    rows = []
    kernel_fn = edvr_module.deform_conv2d

    def checking(x, offset, mask, weight, bias=None, deformable_groups=1):
        out = kernel_fn(x, offset, mask, weight, bias, deformable_groups=deformable_groups)
        args = [None if t is None else t.detach().float() for t in (x, offset, mask, weight, bias)]
        wants = {"plain": (None, 1e-4 if x.dtype == torch.float32 else 2.0 ** -7)}
        if x.dtype == torch.bfloat16:
            wants["plain bf16 columns"] = (torch.bfloat16, 2.0 ** -8)
        row = dict(call=len(rows), dims=list(x.shape), dtype=str(x.dtype).replace("torch.", ""))
        for ref_name, (compute_dtype, tol) in wants.items():
            with torch.no_grad():
                ref = deform_conv2d_ref(*args, deformable_groups=deformable_groups,
                                        compute_dtype=compute_dtype)
                err = float((out.detach().float() - ref).abs().max())
                lim = tol * float(ref.abs().max())
            del ref
            row[ref_name] = dict(max_abs_err=err, tol=lim)
            check(err <= lim, f"{what}: K1 call {len(rows)} {tuple(x.shape)} {x.dtype} vs "
                              f"{ref_name}: max|err| {err:.3e} > {lim:.3e}")
        rows.append(row)
        return out

    edvr_module.deform_conv2d = checking
    try:
        run()
    finally:
        edvr_module.deform_conv2d = kernel_fn
    worst = max(r["plain"]["max_abs_err"] / r["plain"]["tol"] for r in rows)
    print(f"[surface] {what}: K1 vs plain DCN on each of its {len(rows)} calls, shapes "
          f"{sorted({tuple(r['dims']) for r in rows})}: ok (largest max|err| / tol "
          f"{worst:.3f})")
    return rows


def phase_surface(smi: str, gen: torch.Generator, lq: np.ndarray, duf_lq: np.ndarray) -> dict:
    out = {}
    # 8a: plain eval, REDS-shaped, through create_model -> make_infer_fn /
    # make_seq_infer_fn -> evaluate_dataset. The timed runs serve (no GT in
    # the set, so nothing is scored: RGB SSIM of 720p frames on the host
    # would outweigh the card); PSNR is computed from the recorded SR.
    reds_lq, reds_gt = synthetic_clip(gen, REDS_T, REDS_H, REDS_W)
    serve_set = MemoryTestSet({"000": (reds_lq, None)}, EDVR_REDS4["nframes"], "new_info")
    models = eval_models(EDVR_REDS4, gen)
    expect = {"dcn_fwd": -(-REDS_T // EVAL_CHUNK) * 4}
    srs = {}
    for dt_name, model in models.items():
        # Warm-up (cuDNN plans at these shapes), with every K1 call of the
        # run held against the plain DCN.
        out[f"8a {dt_name} K1 vs plain"] = checked_dcn_calls(
            lambda: evaluate_dataset(model.make_infer_fn(), serve_set, n_frames=5,
                                     padding="new_info", chunk=EVAL_CHUNK),
            f"8a {dt_name}-windows")
        for seq in (False, True):
            mode = f"{dt_name}-{'seq' if seq else 'windows'}"
            outs, secs = [], []
            infer = recorded(model.make_infer_fn(), outs, secs)
            seq_fn = recorded(model.make_seq_infer_fn(), outs, secs) if seq else None
            reset_all_counts()
            held = torch.cuda.memory_allocated()  # what earlier phases keep (recorded calls)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = evaluate_dataset(infer, serve_set, n_frames=5, padding="new_info",
                                   chunk=EVAL_CHUNK, seq_fn=seq_fn)
            wall = time.perf_counter() - t0
            counts, peak = all_counts(), torch.cuda.max_memory_allocated() - held
            check_only(counts, expect, f"8a {mode}")
            sr = srs[mode] = np.concatenate(outs)
            check(sr.shape == reds_gt.shape and bool(np.isfinite(sr).all()), f"8a {mode}: SR")
            check(res["000"]["frames"] == REDS_T and "_avg" not in res, f"8a {mode}: {res}")
            psnr = float(np.mean([calculate_psnr(tensor2img(a).astype(np.float64),
                                                 tensor2img(b).astype(np.float64))
                                  for a, b in zip(sr, reds_gt)]))
            check(math.isfinite(psnr), f"8a {mode}: PSNR {psnr}")
            out[f"8a {mode}"] = dict(fps=REDS_T / wall, infer_fps=REDS_T / sum(secs),
                                     secs=wall, peak=peak, held=held, psnr=psnr, counts=counts)
            print(f"[surface] 8a REDS4 EDVR-M {mode:13s} {REDS_T / wall:.3f} frames/s "
                  f"({REDS_T / sum(secs):.3f} in the forwards) peak {peak / 2**30:.2f} GiB "
                  f"above the {held / 2**30:.2f} held before  "
                  f"PSNR-RGB {psnr:.3f}  launches {({k: v for k, v in counts.items() if v})}  "
                  f"[{smi}]")
    d32 = float(np.abs(srs["fp32-windows"] - srs["fp32-seq"]).max())
    d16 = float(np.abs(srs["bf16-windows"] - srs["bf16-seq"]).max())
    print(f"[surface] 8a max |windows - seq|: fp32 {d32:.3e} (limit 1e-4), bf16 {d16:.3e}")
    check(d32 <= 1e-4, f"8a: fp32 window-batched and eval.seq differ by {d32}")
    del models, srs
    torch.cuda.empty_cache()

    # 8b: the Vimeo90K-T protocol: one centre window a septuplet, scored.
    v_lq, v_gt = synthetic_clip(gen, 7 * VIMEO_N, VIMEO_H, VIMEO_W)
    vimeo = MemoryTestSet({f"0000{i + 1}_0001": (v_lq[7 * i: 7 * i + 7], v_gt[7 * i: 7 * i + 7])
                           for i in range(VIMEO_N)}, 7, "new_info", center_only=True)
    model = eval_models(EDVR_VIMEO, gen)["fp32"]
    out["8b K1 vs plain"] = checked_dcn_calls(  # also the warm-up
        lambda: evaluate_dataset(model.make_infer_fn(), vimeo, n_frames=7, padding="new_info",
                                 chunk=EVAL_CHUNK), "8b")
    reset_all_counts()
    t0 = time.perf_counter()
    res = evaluate_dataset(model.make_infer_fn(), vimeo, n_frames=7, padding="new_info",
                           chunk=EVAL_CHUNK, ycbcr=True)
    wall = time.perf_counter() - t0
    counts = all_counts()
    check_only(counts, {"dcn_fwd": 4}, "8b")
    scored = [k for k, r in res.items()
              if k != "_avg" and math.isfinite(r.get("psnr_avg", math.nan))]
    check(len(scored) == VIMEO_N and all(res[k]["frames"] == 1 for k in scored), f"8b: {res}")
    out["8b"] = dict(items=len(scored), psnr_avg=res["_avg"]["psnr_avg"],
                     ssim_avg=res["_avg"]["ssim_avg"], secs=wall, counts=counts)
    print(f"[surface] 8b Vimeo90K-T EDVR 7 frames: {len(scored)} septuplets scored, PSNR-Y "
          f"{res['_avg']['psnr_avg']:.3f} SSIM {res['_avg']['ssim_avg']:.4f} in {wall:.3f} s "
          f"(scoring included)  launches {({k: v for k, v in counts.items() if v})}  [{smi}]")
    del model
    torch.cuda.empty_cache()

    # 8c: DynaVSR with SFDN (test_DynaVSR_SFDN_Vid4.yml) on phase 4's clip,
    # the estimator in the net's dtype.
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    expect = {"dcn_fwd": (cfg.n_steps + -(-CLIP_T // INFER_CHUNK)) * 4,
              "dcn_bwd_data": cfg.n_steps * 4, "dcn_bwd_weight": cfg.n_steps * 4}
    vsr32 = define_G({"network_G": EDVR_M})
    init_weights(vsr32, gen)
    est32 = build_estimator({"which_model_G": "SFDN", "nf": MFDN_NF}, SCALE, 5)
    init_weights(est32, gen)
    for dt_name, dtype in (("fp32", None), ("bf16", "bfloat16")):
        vsr, est = vsr32, est32
        if dtype:
            vsr = define_G({"network_G": {**EDVR_M, "dtype": dtype}})
            vsr.load_state_dict(vsr32.state_dict())
            est = build_estimator({"which_model_G": "SFDN", "nf": MFDN_NF, "dtype": dtype},
                                  SCALE, 5)
            est.load_state_dict(est32.state_dict())
        mode = f"{dt_name}-windows"
        for timed in (False, True):  # warm-up, then the counted and timed clip
            reset_all_counts()
            t0 = time.perf_counter()
            sr, res = run_clip(vsr, est, lq, None, cfg, seq=False, n_frames=5,
                               padding="reflection", n_adapt=N_WINDOWS)
            secs = time.perf_counter() - t0
        counts, losses = all_counts(), res["adapt_losses"]
        check(len(losses) == 5 and all(math.isfinite(v) for v in losses), f"8c {mode}: {losses}")
        check(sr.shape == (CLIP_T, LR_H * SCALE, LR_W * SCALE, 3) and bool(np.isfinite(sr).all()),
              f"8c {mode}: SR")
        check_only(counts, expect, f"8c {mode}")
        out[f"8c {mode}"] = dict(fps=CLIP_T / secs, secs=secs, losses=losses, counts=counts)
        print(f"[surface] 8c DynaVSR EDVR-M + SFDN {mode:13s} {CLIP_T / secs:.3f} frames/s "
              f"({secs:.3f} s/clip)  losses {[f'{v:.6f}' for v in losses]}  launches "
              f"{({k: v for k, v in counts.items() if v})}  [{smi}]")
    del vsr32, est32, vsr, est
    torch.cuda.empty_cache()

    # 8d: DUF-16L with bn_mode grad_stats and optimizer sgd on phase 6's clip.
    # At lr 1 a running variance (~1, whose gradients here are ~1e-6..1e-4)
    # moves by many ulps in 5 steps; at the configs' 1e-6 most would not
    # move at all.
    cfg = AdaptConfig(n_steps=5, lr=1.0, optimizer="sgd", infer_chunk=INFER_CHUNK,
                      bn_mode="grad_stats")
    net = define_G({"scale": SCALE, "network_G": DUF_G})
    init_weights(net, gen)
    est = build_estimator({"nf": MFDN_NF}, SCALE, DUF_FRAMES)
    init_weights(est, gen)
    stats0 = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    for timed in (False, True):
        reset_all_counts()
        t0 = time.perf_counter()
        sr, res = run_clip(net, est, duf_lq, None, cfg, seq=False, n_frames=DUF_FRAMES,
                           padding="new_info", n_adapt=N_WINDOWS)
        secs = time.perf_counter() - t0
    counts, losses = all_counts(), res["adapt_losses"]
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses), f"8d: {losses}")
    check(losses[-1] < losses[0], f"8d: sgd did not lower the loss: {losses}")
    check(bool(np.isfinite(sr).all()), "8d: SR")
    check_only(counts, duf_launches_per_clip(cfg), "8d")
    win = all_windows(CLIP_T, DUF_FRAMES, "new_info")[:N_WINDOWS]
    adapt_windows = torch.as_tensor(duf_lq[win], device="cuda")
    with torch.no_grad():
        slr = est(adapt_windows)
    adapted, _ = make_adapt_fn(cfg, make_model_apply("DUF", SCALE))(
        net, slr, adapt_windows[:, DUF_FRAMES // 2])
    # Every running statistic of the adapted copy moved: its largest change
    # is at least 1e-6 (8 ulps of 1.0).
    adapted_sd = adapted.state_dict()
    moves = {k: float((adapted_sd[k] - v).abs().max()) for k, v in stats0.items()}
    moved = {kind: sum(m >= 1e-6 for k, m in moves.items() if k.endswith(kind))
             for kind in ("running_mean", "running_var")}
    least = {kind: min(m for k, m in moves.items() if k.endswith(kind))
             for kind in ("running_mean", "running_var")}
    check(all(m >= 1e-6 for m in moves.values()),
          f"8d: running statistics that moved by less than 1e-6: "
          f"{ {k: m for k, m in moves.items() if m < 1e-6} }")
    for k, v in net.state_dict().items():
        if k in stats0:
            check(torch.equal(v, stats0[k]), f"8d: the meta model's {k} moved")
    out["8d"] = dict(fps=CLIP_T / secs, secs=secs, losses=losses, counts=counts,
                     stats_moved=moved, least_move=least, stats=len(stats0), lr=cfg.lr)
    print(f"[surface] 8d DUF-16L grad_stats + sgd (lr {cfg.lr}) fp32-windows "
          f"{CLIP_T / secs:.3f} frames/s  losses {[f'{v:.6f}' for v in losses]}  launches "
          f"{({k: v for k, v in counts.items() if v})}; statistics moved in the adapted "
          f"copy {moved} of {len(stats0) // 2} each (least largest change {least}), none in "
          f"the meta model  [{smi}]")
    del net, est, adapted
    torch.cuda.empty_cache()

    # 8e: each EDVR variant, one window with the kernels and with the plain DCN.
    for label, extra in EDVR_VARIANTS.items():
        net = define_G({"network_G": {**EDVR_REDS4, **extra}})
        init_weights(net, gen)
        frames = reds_gt if extra.get("HR_in") else reds_lq
        window = torch.as_tensor(frames[all_windows(REDS_T, 5, "new_info")[:1]], device="cuda")
        kernel_fn = edvr_module.deform_conv2d
        with torch.no_grad():
            reset_all_counts()
            sr_kernel = net(window)
            counts = all_counts()
            edvr_module.deform_conv2d = deform_conv2d_ref
            try:
                sr_plain = net(window)
            finally:
                edvr_module.deform_conv2d = kernel_fn
        check_only(counts, {"dcn_fwd": 4}, f"8e {label}")
        d = float((sr_kernel - sr_plain).abs().max())
        out[f"8e {label}"] = dict(max_abs_diff=d, sr_shape=list(sr_kernel.shape),
                                  sr_absmax=float(sr_plain.abs().max()))
        print(f"[surface] 8e EDVR-M {label}: {tuple(window.shape)} -> {tuple(sr_kernel.shape)}, "
              f"kernels vs plain DCN (fp32) max |SR diff| {d:.3e} (limit 1e-3; max |SR| "
              f"{out[f'8e {label}']['sr_absmax']:.3f})")
        check(d <= 1e-3, f"8e {label}: EDVR with the kernels differs from the plain DCN by {d}")
        del net
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 9
# Supervised training through cli/train.train at EDVR-M's full width, on
# REDS-shaped data: 4 clips outside REDS4 of 16 frames, GT 720x1280 and LQ
# 180x320 (REDS' frame sizes), written as raw-byte LMDBs. 9a takes
# configs/train/train_EDVR_M_REDS.yml's fields (fp32, Gd 8), 9b
# train_EDVR_M_TPU.yml's (bf16, Gd 2). Each trains, then resumes from the
# state saved at TRAIN_SAVE to the same iteration.
TRAIN_CLIPS, TRAIN_T, TRAIN_SAVE = ("001", "002", "003", "004"), 16, 4
TRAIN_RUNS = {"9a": dict(groups=8, dtype=None, restart_weights=[1, 1, 1], niter=8,
                         name="EDVR_M_REDS"),
              "9b": dict(groups=2, dtype="bf16", restart_weights=[1, 0.5, 0.5, 0.5], niter=6,
                         name="EDVR_M_TPU_REDS")}


def write_train_lmdbs(gen: torch.Generator, root: str) -> tuple:
    """The GT and LQ LMDBs: key '<clip>_<frame:08d>', raw BGR uint8 bytes
    and a '<key>.meta' entry 'HxWxC' (the card's machine has no image
    codec). Frames: phase 4's smooth-clip generator at REDS' size; LQ =
    the port's MATLAB-bicubic imresize(GT, 1/4), each quantised to uint8."""
    from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter

    paths = (f"{root}/train_sharp.lmdb", f"{root}/train_sharp_bicubic.lmdb")
    with LmdbWriter(paths[0]) as gt_w, LmdbWriter(paths[1]) as lq_w:
        for clip in TRAIN_CLIPS:
            lq, hr = synthetic_clip(gen, TRAIN_T, REDS_H, REDS_W)
            for w, frames in ((gt_w, hr), (lq_w, lq)):
                u8 = np.clip(np.round(frames * 255.0), 0, 255).astype(np.uint8)[..., ::-1]
                for i, f in enumerate(u8):
                    key = f"{clip}_{i:08d}".encode()
                    w.put(key, np.ascontiguousarray(f).tobytes())
                    w.put(key + b".meta", "x".join(map(str, f.shape)).encode())
    return paths


def train_opt(run: dict, gt: str, lq: str, root: str, resume: str = None) -> dict:
    """The training config as cli/train.py derives it from the YAML (no
    YAML parser on the card's machine)."""
    from dynavsr_tpu_torch.config.options import derive

    opt = {
        "name": run["name"], "model": "video_base", "scale": SCALE,
        "datasets": {"train": {
            "name": "REDS", "mode": "REDS", "interval_list": [1], "random_reverse": False,
            "dataroot_GT": gt, "dataroot_LQ": lq, "N_frames": 5, "use_shuffle": True,
            "n_workers": 3, "batch_size": 32, "GT_size": 256, "LQ_size": 64,
            "use_flip": True, "use_rot": True}},
        "network_G": {**EDVR_M, "groups": run["groups"], "predeblur": False, "HR_in": False,
                      **({"dtype": run["dtype"]} if run["dtype"] else {})},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume},
        "train": {"lr_G": 4e-4, "lr_scheme": "CosineAnnealingLR_Restart", "beta1": 0.9,
                  "beta2": 0.99, "niter": run["niter"], "warmup_iter": -1,
                  "T_period": [150000] * 4, "restart_weights": run["restart_weights"],
                  "eta_min": 1e-7, "pixel_criterion": "cb", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": TRAIN_SAVE},
    }
    return derive(opt, is_train=True, root=root)


class TrainingProbe:
    """Wraps a model class's methods while cli/train.train runs: each
    update's time (host clock, the card synchronised before and after),
    its K1-K10 launches, the batches fed to the iterations in `keep`
    (1-based; every array of the fed dict, on the host), and at a resume
    whether the restored net and Adam moments are bitwise the saved
    files'."""

    def __init__(self, keep, cls=None):
        from dynavsr_tpu_torch.models import video_base_model as vbm

        self.cls = cls or vbm.VideoBaseModel
        self.keep = {keep} if isinstance(keep, int) else set(keep)
        self.step_s, self.step_counts, self.batches, self.resumed = [], [], {}, None
        names = ("optimize_parameters", "feed_data", "resume_training")
        self._orig = {n: getattr(self.cls, n) for n in names}
        self._own = {n for n in names if n in vars(self.cls)}

    @property
    def kept(self):
        return self.batches.get(min(self.keep)) if self.keep else None

    def __enter__(self):
        probe, orig = self, self._orig

        def optimize_parameters(model, step=None):
            before = all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig["optimize_parameters"](model, step)
            torch.cuda.synchronize()
            probe.step_s.append(time.perf_counter() - t0)
            probe.step_counts.append({k: v - before[k] for k, v in all_counts().items()})

        def feed_data(model, data, need_GT=True):
            if model.step + 1 in probe.keep:
                probe.batches[model.step + 1] = {
                    k: (v.detach().cpu().numpy() if torch.is_tensor(v) else np.array(v))
                    for k, v in data.items() if torch.is_tensor(v) or isinstance(v, np.ndarray)}
            orig["feed_data"](model, data, need_GT)

        def resume_training(model, state_path):
            epoch = orig["resume_training"](model, state_path)
            saved = torch.load(f"{model.opt['path']['models']}/{model.step}_G.pth",
                               map_location="cpu", weights_only=True)
            state = torch.load(state_path, map_location="cpu", weights_only=True)
            net_ok = all(torch.equal(v.cpu(), saved[k]) for k, v in model.netG.state_dict().items())
            ours = model.optimizer.state_dict()["state"]
            adam_ok = ours.keys() == state["optimizer"]["state"].keys() and all(
                torch.equal(s[n].cpu(), state["optimizer"]["state"][k][n])
                for k, s in ours.items() for n in ("step", "exp_avg", "exp_avg_sq"))
            probe.resumed = dict(iter=model.step, saved_epoch=epoch, net_bitwise=net_ok,
                                 adam_bitwise=adam_ok)
            return epoch

        for name, fn in (("optimize_parameters", optimize_parameters),
                         ("feed_data", feed_data), ("resume_training", resume_training)):
            setattr(self.cls, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            if name in self._own:
                setattr(self.cls, name, fn)
            else:
                delattr(self.cls, name)


def read_metrics(opt: dict) -> list:
    with open(f"{opt['path']['root']}/tb_logger/{opt['name']}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def record_step_dcn_calls(run) -> list:
    """Run `run()` (one update) with every DCN call of EDVR recorded: its
    inputs and the gradient that reached its output."""
    calls = []
    kernel_fn = edvr_module.deform_conv2d

    def recording(x, offset, mask, weight, bias=None, deformable_groups=1):
        out = kernel_fn(x, offset, mask, weight, bias, deformable_groups=deformable_groups)
        rec = dict(gd=deformable_groups, args=[None if t is None else t.detach().clone()
                                               for t in (x, offset, mask, weight, bias)])
        out.register_hook(lambda g: rec.__setitem__("cot", g.detach().clone()))
        calls.append(rec)
        return out

    edvr_module.deform_conv2d = recording
    try:
        run()
    finally:
        edvr_module.deform_conv2d = kernel_fn
    return calls


def phase_train(smi: str, gt: str, lq: str, root: str) -> tuple:
    """9a and 9b on the LMDBs of write_train_lmdbs; returns ({run:
    measurements}, kernel rows at the training shapes)."""
    from dynavsr_tpu_torch.cli.train import train
    from dynavsr_tpu_torch.data.loader import create_dataloader, create_dataset

    out, rows = {}, []
    for tag, run in TRAIN_RUNS.items():
        niter = run["niter"]
        opt = train_opt(run, gt, lq, root)
        reset_all_counts()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t_run = time.perf_counter()
        with TrainingProbe(keep=TRAIN_SAVE + 1) as probe:
            done = train(opt)
        run_s = time.perf_counter() - t_run
        counts, peak = all_counts(), torch.cuda.max_memory_allocated() - held
        check(done == niter and len(probe.step_s) == niter,
              f"{tag}: trained {done} iterations ({len(probe.step_s)} updates), not {niter}")
        check_only(counts, {k: 4 * niter for k in DCN_KERNELS}, f"{tag} training")
        for i, c in enumerate(probe.step_counts):
            check_only(c, dict.fromkeys(DCN_KERNELS, 4), f"{tag} update {i + 1}")
        recs = read_metrics(opt)
        check([r["step"] for r in recs] == list(range(1, niter + 1)), f"{tag}: {recs}")
        l_pix = [r["l_pix"] for r in recs]
        offs = [r["dcn_offset_absmean"] for r in recs]
        check(all(math.isfinite(v) for v in l_pix + offs), f"{tag}: l_pix {l_pix}, {offs}")
        check(np.mean(l_pix[-2:]) < np.mean(l_pix[:2]),
              f"{tag}: the loss did not fall: {l_pix}")
        check(offs[0] == 0.0, f"{tag}: offsets at update 1 are {offs[0]}, not 0")
        first_batch = probe.kept

        # Resume from the state saved at TRAIN_SAVE, to the same end.
        state = f"{opt['path']['training_state']}/{TRAIN_SAVE}.state"
        with TrainingProbe(keep=TRAIN_SAVE + 1) as again:
            check(train(train_opt(run, gt, lq, root, resume=state)) == niter,
                  f"{tag}: the resumed run did not reach {niter}")
        res = again.resumed
        check(res is not None and res["iter"] == TRAIN_SAVE and res["net_bitwise"]
              and res["adam_bitwise"], f"{tag}: resume restored {res}")
        check(len(again.step_s) == niter - TRAIN_SAVE,
              f"{tag}: the resumed run made {len(again.step_s)} updates")
        same = {k: bool(np.array_equal(first_batch[k], again.kept[k])) for k in first_batch}
        check(all(same.values()), f"{tag}: the resumed run's batch {TRAIN_SAVE + 1} "
                                   f"differs from the uninterrupted run's: {same}")
        batch_sums = [float(first_batch["LQs"].sum()), float(again.kept["LQs"].sum())]

        # A trained copy: one update's DCN calls held against the plain
        # version (and timed at each shape), then 2 updates profiled.
        trained = {**opt, "path": {**opt["path"], "resume_state": None,
                                   "pretrain_model_G": f"{opt['path']['models']}/{niter}_G.pth"}}
        model = create_model(trained)
        dataset_opt = trained["datasets"]["train"]
        loader = create_dataloader(create_dataset(dataset_opt), dataset_opt, trained)

        def epochs():
            for epoch in range(100):
                loader.set_epoch(epoch)
                yield from loader

        batches = epochs()
        model.feed_data(next(batches))
        model.optimize_parameters()  # warm-up
        model.feed_data(next(batches))
        calls = record_step_dcn_calls(model.optimize_parameters)
        check(len(calls) == 4 and all("cot" in c for c in calls),
              f"{tag}: recorded {len(calls)} DCN calls")
        timed_shapes = set()
        for c in calls:
            shape = tuple(c["args"][0].shape)
            label = dcn_label("train", shape)
            for row in against_plain(label, *c["args"], c["cot"], c["gd"],
                                     timed=shape not in timed_shapes):
                row["run"] = tag
                rows.append(row)
            timed_shapes.add(shape)
        del calls
        torch.cuda.empty_cache()

        def two_updates():
            for _ in range(2):
                model.feed_data(next(batches))
                model.optimize_parameters()
            torch.cuda.synchronize()

        prof = profile_clip(two_updates, f"{tag} two updates", smi, DCN_KERNELS)
        batches.close()
        del model, batches, loader
        torch.cuda.empty_cache()

        timed = probe.step_s[2:]  # updates 1-2 warm up
        waits = [r["data_wait_s"] for r in recs]
        out[tag] = dict(
            niter=niter, run_s=run_s, step_s=probe.step_s, s_per_iter=float(np.mean(timed)),
            samples_per_s=32 / float(np.mean(timed)),
            loop_step_s=[r["step_time_s"] for r in recs], data_wait_s=waits,
            mean_data_wait_s=float(np.mean(waits[2:])), peak_gib=peak / 2**30,
            l_pix=l_pix, grad_norm=[r["grad_norm"] for r in recs], offset_absmean=offs,
            launches=counts, per_update=probe.step_counts[0], resumed=res,
            batch5_lq_sums=batch_sums, busy_ms=prof.get("busy_ms"),
            idle_share=prof.get("idle_share"),
            dcn_ms_per_update={k: v / 2 for k, v in prof.get("kernel_ms", {}).items()},
            top=[(n[:80], ms) for n, ms in prof.get("top", [])])
        print(f"[train] {tag} {run['name']} (Gd {run['groups']}, "
              f"{run['dtype'] or 'fp32'}): {niter} updates in {run_s:.1f} s; updates 3-{niter} "
              f"{out[tag]['s_per_iter']:.4f} s each, {out[tag]['samples_per_s']:.1f} "
              f"samples/s; loader wait {out[tag]['mean_data_wait_s'] * 1e3:.1f} ms an "
              f"update; peak {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} held; "
              f"l_pix {[round(v, 5) for v in l_pix]}; resumed at {TRAIN_SAVE} bitwise, "
              f"batch {TRAIN_SAVE + 1} equal; launches {({k: v for k, v in counts.items() if v})}"
              f"  [{smi}]")
    return out, rows



# --------------------------------------------------------------- phase 10
# DynaVSR's training at full width: the downscalers on Vimeo90K-shaped
# septuplets (448x256, raw-byte LMDB), then second-order meta-training of
# EDVR-M on the REDS-shaped LMDB of phase 9 with an MFDN in the loop.
VIMEO_SEPT, VIMEO_T, VIMEO_LR = 32, 7, (64, 112)  # 256x448 HR
DOWN_RUNS = {"10a": dict(which="MFDN", niter=8, save=4),
             "10b": dict(which="SFDN", niter=4, save=None)}
META_NITER, META_SAVE, META_BATCH = 6, 3, 8
TANGENT_KERNELS = ("dcn_fwd_tangent", "dcn_bwd_weight_tangent", "dcn_bwd_data_tangent")
TANGENT_RTOL = {"dcn_fwd_tangent": 0.0, "dcn_bwd_weight_tangent": 1e-5,
                "dcn_bwd_data_tangent": (1e-5, 0.0, 0.0)}
# K1-K3 and K8-K10 a meta update (4 DCNs in PCD; the inner forward is
# recomputed twice under remat): the count the CPU test
# test_torch_port_meta.py::test_meta_update_launches_with_the_kernels_stand_ins holds.
META_LAUNCHES = {"dcn_fwd": 28, "dcn_bwd_data": 24, "dcn_bwd_weight": 20,
                 "dcn_fwd_tangent": 4, "dcn_bwd_weight_tangent": 4, "dcn_bwd_data_tangent": 4}
# Searched for an alpha whose second-order term is >= 5 % of the meta
# gradient: there the kernels' fp32 differences from the plain DCN in the
# whole gradient (measured up to 6e-5 of it) stay far below the check's
# 1e-2 of the term.
ALPHAS = (1e-3, 1e-2, 1e-1, 1.0, 10.0)
TERM_SHARE = 5e-2
# Phase 11's term checks take a try whose fp32 plain term is within this of
# the float64 one (second_order_term).
GAUGE = 1e-3
OFFSET_STD = 0.05  # the redrawn offset convs of 10d's term check


def write_vimeo_lmdb(gen: torch.Generator, root: str) -> str:
    """Vimeo90K-shaped septuplets (key '<seq>_<clip>_<frame:08d>', raw BGR
    bytes and a '.meta' entry), phase 4's smooth-clip generator."""
    from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter

    path = f"{root}/vimeo90k_train.lmdb"
    with LmdbWriter(path) as w:
        for i in range(VIMEO_SEPT):
            _, hr = synthetic_clip(gen, VIMEO_T, *VIMEO_LR)
            u8 = np.clip(np.round(hr * 255.0), 0, 255).astype(np.uint8)[..., ::-1]
            for f, frame in enumerate(u8):
                key = f"{i + 1:05d}_0001_{f:08d}".encode()
                w.put(key, np.ascontiguousarray(frame).tobytes())
                w.put(key + b".meta", "x".join(map(str, frame.shape)).encode())
    return path


def downscaler_opt(which: str, niter: int, save, gt: str, root: str, frames: int = VIMEO_T,
                   resume: str = None) -> dict:
    """train_MFDN_Vimeo90K.yml / train_SFDN_Vimeo90K.yml as cli/train.py
    derives them."""
    from dynavsr_tpu_torch.config.options import derive

    opt = {
        "name": f"{which}_{frames}f", "model": "downscaler", "scale": SCALE,
        "datasets": {"train": {"name": "Vimeo90K", "mode": "meta", "dataroot_GT": gt,
                               "N_frames": frames, "GT_size": 256, "use_shuffle": True,
                               "n_workers": 3, "batch_size": 16}},
        "network_G": {"which_model_G": which, "nf": 64},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume},
        "train": {"lr_G": 1e-4, "lr_scheme": "MultiStepLR_Restart",
                  "lr_steps": [100000, 200000], "lr_gamma": 0.5, "beta1": 0.9, "beta2": 0.99,
                  "niter": niter, "pixel_criterion": "l1", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": save or 5e3},
    }
    return derive(opt, is_train=True, root=root)


def meta_opt(gt: str, est: str, root: str, resume: str = None) -> dict:
    """train_DynaVSR_EDVR_REDS.yml as cli/train.py derives it, from random
    weights (no EDVR checkpoint in the repo) with network_E from `est`."""
    from dynavsr_tpu_torch.config.options import derive

    opt = {
        "name": "DynaVSR_EDVR_M_REDS", "model": "video_meta", "scale": SCALE,
        "datasets": {"train": {"name": "REDS_meta", "mode": "meta", "dataroot_GT": gt,
                               "N_frames": 5, "GT_size": 256, "use_shuffle": True,
                               "n_workers": 3, "batch_size": META_BATCH}},
        "network_G": {**EDVR_M, "predeblur": False, "HR_in": False},
        "network_E": {"which_model_G": "MFDN", "nf": 64},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume,
                 "pretrain_model_E": est},
        "train": {"lr_G": 1e-5, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                  "niter": META_NITER, "maml_lr_alpha": 1e-5, "maml_adapt_iter": 1,
                  "first_order": False, "pixel_criterion": "cb", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": META_SAVE},
    }
    return derive(opt, is_train=True, root=root)


def train_and_resume(tag: str, make_opt, niter: int, save, cls, per_update: dict = None):
    """cli/train.train over make_opt(None), then (with `save`) resumed from
    the state saved at `save` to the same end: the restored net and Adam
    moments bitwise the saved files', and the resumed run's next batch
    bitwise the uninterrupted run's. Returns the measurements."""
    from dynavsr_tpu_torch.cli.train import train

    opt = make_opt(None)
    reset_all_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    keep = {1} | ({save + 1} if save else set())
    with TrainingProbe(keep=keep, cls=cls) as probe:
        done = train(opt)
    run_s = time.perf_counter() - t_run
    counts, peak = all_counts(), torch.cuda.max_memory_allocated() - held
    check(done == niter and len(probe.step_s) == niter,
          f"{tag}: trained {done} iterations ({len(probe.step_s)} updates), not {niter}")
    if per_update is not None:
        for i, c in enumerate(probe.step_counts):
            check_only(c, per_update, f"{tag} update {i + 1}")
    recs = read_metrics(opt)
    check([r["step"] for r in recs] == list(range(1, niter + 1)), f"{tag}: {recs}")
    res, same = None, None
    if save:
        state = f"{opt['path']['training_state']}/{save}.state"
        with TrainingProbe(keep=save + 1, cls=cls) as again:
            check(train(make_opt(state)) == niter, f"{tag}: the resumed run did not reach {niter}")
        res = again.resumed
        check(res is not None and res["iter"] == save and res["net_bitwise"]
              and res["adam_bitwise"], f"{tag}: resume restored {res}")
        check(len(again.step_s) == niter - save,
              f"{tag}: the resumed run made {len(again.step_s)} updates")
        first, second = probe.batches[save + 1], again.kept
        same = {k: bool(np.array_equal(first[k], second[k])) for k in first}
        check(same and all(same.values()), f"{tag}: the resumed run's batch {save + 1} "
                                           f"differs from the uninterrupted run's: {same}")
    waits = [r["data_wait_s"] for r in recs]
    timed = probe.step_s[2:]  # updates 1-2 warm up
    return dict(opt=opt, niter=niter, run_s=run_s, step_s=probe.step_s,
                s_per_iter=float(np.mean(timed)), data_wait_s=waits,
                mean_data_wait_s=float(np.mean(waits[2:])), peak_gib=peak / 2**30,
                held_gib=held / 2**30, launches=counts, per_update=probe.step_counts[0],
                resumed=res, resumed_batch_bitwise=same, recs=recs, first_batch=probe.batches[1])


def trained_model(opt: dict):
    """The final weights of a run, through create_model."""
    final = f"{opt['path']['models']}/{opt['train']['niter']}_G.pth"
    return create_model({**opt, "path": {**opt["path"], "resume_state": None,
                                         "pretrain_model_G": final}})


def _dcn_vjp(x, offset, mask, weight, cot, gd, wrt):
    """The plain DCN's gradients in the inputs `wrt` (indices into (x,
    offset, mask, weight)), in fp32."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().float().requires_grad_()
                  for t in (x, offset, mask, weight)]
        out = deform_conv2d_ref(*leaves, deformable_groups=gd)
        grads = torch.autograd.grad(out, [leaves[i] for i in wrt if leaves[i] is not None],
                                    cot.float())
    return list(grads)


# The plain version of each K1-K3, K8-K10 wrapper, on its own arguments: the
# non-None outputs in the wrapper's order (K1's `_fwd` also returns its
# channels-last copy of x, which is not compared).
PLAIN_DCN_CALLS = {
    "_fwd": lambda x, offset, mask, weight, bias, gd: [deform_conv2d_ref(
        x.float(), offset, mask, weight, bias, deformable_groups=gd)],
    "dcn_bwd_data": lambda x, offset, mask, weight, cot, gd: _dcn_vjp(
        x, offset, mask, weight, cot, gd, (0, 1, 2)),
    "dcn_bwd_weight": lambda x, offset, mask, cot, gd: _dcn_vjp(
        x, offset, mask, torch.zeros(cot.shape[1], x.shape[1], 3, 3, device=x.device), cot,
        gd, (3,)),
    "dcn_fwd_tangent": lambda *a: [dcn_fwd_tangent_ref(*a)],
    "dcn_bwd_weight_tangent": lambda *a: [dcn_bwd_weight_tangent_ref(*a)],
    "dcn_bwd_data_tangent": lambda *a: [t for t in dcn_bwd_data_tangent_ref(*a)
                                        if t is not None],
}


def checked_calls(run, module, plain: dict, keep=(), by_shape: bool = False) -> tuple:
    """Run `run()` with every call of `module`'s wrappers named in `plain`
    held against plain[name] on the same inputs as it happens (phase 3's
    tolerance: 1e-4 of the plain result's largest value); returns one row a
    call, and the arguments of the largest call of each wrapper in `keep`
    (with `by_shape`, of its first call at each input shape, keyed (name,
    shape))."""
    rows, kept = [], {}
    orig = {n: getattr(module, n) for n in plain}

    def recording(name):
        def call(*args, **kwargs):
            out = orig[name](*args, **kwargs)
            args = args + tuple(kwargs.values())
            got = [out] if torch.is_tensor(out) else [t for t in out if t is not None]
            with torch.no_grad():
                want = plain[name](*args)
            err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            rows.append(dict(name="dcn_fwd" if name == "_fwd" else name,
                             dims=list(args[0].shape), max_abs_err=err, tol=1e-4 * scale,
                             ok=err <= 1e-4 * scale))
            key = (name, tuple(args[0].shape)) if by_shape else name
            if name in keep and (key not in kept or (
                    not by_shape and args[0].numel() > kept[key][0].numel())):
                kept[key] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return out
        return call

    for n in orig:
        setattr(module, n, recording(n))
    try:
        run()
    finally:
        for n, f in orig.items():
            setattr(module, n, f)
    return rows, kept


def meta_gradient(model, batch, alpha: float, first_order: bool) -> torch.Tensor:
    """The meta gradient (flattened, in meta_variables order: the
    parameters, then any BatchNorm running statistics) at the model's
    weights on `batch`, without an update."""
    from dynavsr_tpu_torch.train.meta import MetaConfig, meta_loss, meta_variables

    cfg = MetaConfig(inner_lr=alpha, first_order=first_order)
    leaves = {k: t.detach().requires_grad_() for k, t in meta_variables(model.netG).items()}
    outer, _ = meta_loss(model.netG, leaves, batch, cfg, make_model_apply(model.netG.arch, SCALE))
    grads = torch.autograd.grad(outer, list(leaves.values()), allow_unused=True)
    return torch.cat([(torch.zeros_like(t) if g is None else g).flatten()
                      for g, t in zip(grads, leaves.values())])


def term_vs_plain(model, batch, alpha: float, swap, gauge: bool = False) -> dict:
    """The second-order part of the meta gradient (second minus first
    order) at `alpha`, with the kernels and with the plain op (`swap` =
    (module, attribute, plain function)): its share of the gradient, the
    relative norm of their difference, their cosine. With `gauge`, also the
    plain op's term on a float64 copy of the net and batch, and each fp32
    term's distance to it (`plain_vs_f64`, `kernel_vs_f64`)."""
    g1, g2 = meta_gradient(model, batch, alpha, True), meta_gradient(model, batch, alpha, False)
    module, attr, plain_fn = swap
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain_fn)
    try:
        p1, p2 = (meta_gradient(model, batch, alpha, True),
                  meta_gradient(model, batch, alpha, False))
        if gauge:
            m64 = types.SimpleNamespace(netG=copy.deepcopy(model.netG).double())
            b64 = {k: v.double() for k, v in batch.items()}
            d64 = meta_gradient(m64, b64, alpha, False) - meta_gradient(m64, b64, alpha, True)
            del m64
    finally:
        setattr(module, attr, kernel_fn)
    d_kernel, d_plain = g2 - g1, p2 - p1
    out = dict(alpha=alpha, share=float(d_kernel.norm() / g2.norm()),
               rel_diff=float((d_kernel - d_plain).norm() / d_plain.norm()),
               cosine=float(torch.nn.functional.cosine_similarity(d_kernel, d_plain, dim=0)),
               grad_rel_diff=float((g2 - p2).norm() / p2.norm()))
    if gauge:
        out.update(plain_vs_f64=float((d_plain.double() - d64).norm() / d64.norm()),
                   kernel_vs_f64=float((d_kernel.double() - d64).norm() / d64.norm()))
    return out


def second_order_term(tag: str, model, batch, gen: torch.Generator, swap, redraw=None,
                      std: float = 0.0, tries: int = 1) -> dict:
    """The check of the second-order term as a whole, kernels against the
    plain op (`swap`; relative norm <= 1e-2), at the first alpha of ALPHAS
    whose term is >= TERM_SHARE of the meta gradient. With `redraw` (a
    predicate on parameter names) it runs with those parameters redrawn
    N(0, std) from the seed: a trained-from-zero DCN offset conv or a
    near-zero SpyNet flow puts the bilinear samples on the pixel grid,
    where the derivative jumps and 1e-7 differences between two fp32 paths
    take different sides of the kink (read there too, and reported).

    With `tries` > 1 each try is gauged (term_vs_plain's float64 term), and
    the check is held on the first try whose fp32 plain term is within
    GAUGE of the float64 one; the next try redraws (or, without `redraw`,
    takes the next windows of the batch). Where fp32 rounding alone decides
    which side of a kink samples take, the fp32 term is ill-conditioned: on
    TOF's meta batch, with some SpyNet biases, the kernels' and the plain
    warp's fp32 terms lay equally far from the float64 one, and two runs of
    the same comparison disagreed by orders of magnitude, a reading that
    says nothing of the kernels. The model's weights are restored after."""
    redrawn = {n: p for n, p in model.netG.named_parameters() if redraw and redraw(n)}
    own = {n: p.detach().clone() for n, p in redrawn.items()}
    nb = next(iter(batch.values())).shape[0]
    per_try = nb // tries
    readings, held = [], None
    for t in range(tries):
        sub = batch if tries == 1 or redrawn else {k: v[t * per_try:(t + 1) * per_try]
                                                    for k, v in batch.items()}
        with torch.no_grad():
            for p in redrawn.values():
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
        ratios, alpha = {}, None
        for a in (1e-5,) + ALPHAS:
            g1, g2 = meta_gradient(model, sub, a, True), meta_gradient(model, sub, a, False)
            ratios[a] = float((g2 - g1).norm() / g2.norm())
            if a > 1e-5 and ratios[a] >= TERM_SHARE and math.isfinite(ratios[a]):
                alpha = a
                break
        check(alpha is not None,
              f"{tag}: no alpha gives a second-order term >= {TERM_SHARE}: {ratios}")
        reading = term_vs_plain(model, sub, alpha, swap, gauge=tries > 1)
        reading.update(ratios=ratios, windows=next(iter(sub.values())).shape[0])
        readings.append(reading)
        if tries == 1 or reading["plain_vs_f64"] <= GAUGE:
            held = reading
            break
    check(held is not None, f"{tag}: no try gives an fp32 plain term within {GAUGE} of the "
                            f"float64 one: {readings}")
    with torch.no_grad():
        for n, p in redrawn.items():
            p.copy_(own[n])
    on_grid = term_vs_plain(model, sub, held["alpha"], swap) if redrawn else held
    what = f"{len(redrawn)} tensors redrawn N(0, {std})" if redrawn else "its own weights"
    gauges = [f"{r.get('plain_vs_f64', math.nan):.2e}" for r in readings]
    gauged = (f"; {len(readings)} tries, fp32 plain term vs float64 {gauges} (gauge "
              f"{GAUGE}), kernels vs float64 {held.get('kernel_vs_f64', math.nan):.3e}"
              ) if tries > 1 else ""
    own_text = (f"; with the trained weights (samples on the grid's kinks): term "
                f"{on_grid['share']:.3e} of the gradient, |diff|/|term| "
                f"{on_grid['rel_diff']:.3e}, cosine {on_grid['cosine']:.6f}") if redrawn else ""
    print(f"[{tag}] second-order term (meta gradient second - first order), {what}, "
          f"{held['windows']} window(s): |term|/|grad| by alpha {held['ratios']}; at alpha "
          f"{held['alpha']}: kernels vs plain {swap[1]} |diff|/|term| {held['rel_diff']:.3e} "
          f"(tol 1e-2), cosine {held['cosine']:.6f}, whole gradient |diff|/|grad| "
          f"{held['grad_rel_diff']:.3e}{gauged}{own_text}")
    check(held["rel_diff"] <= 1e-2,
          f"{tag}: the second-order term differs from the plain op's by {held['rel_diff']}")
    return dict(alpha=held["alpha"], ratios=held["ratios"], off_grid=held, on_grid=on_grid,
                tries=readings)


def tangent_bound(name, shape, gd):
    """(bound_ms, bound_by, bytes, flops) of one fp32 K8-K10 call: each
    input read once, each output written once; operations = the 2*B*HW*C*
    Cout*9 product (gc for K10)."""
    b, c, h, w = shape
    px, e = b * h * w, 4
    x, off, msk, wgt, go = px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e, c * c * 9 * e, \
        px * c * e
    nbytes = x + 2 * off + msk + {"dcn_fwd_tangent": wgt + px * c * e,
                                  "dcn_bwd_weight_tangent": go + wgt,
                                  "dcn_bwd_data_tangent": wgt + go + x + off + msk}[name]
    flops = 2 * px * c * c * 9
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_meta(smi: str, gen: torch.Generator, reds_gt: str, root: str) -> tuple:
    """10a-10d; returns (measurements, K8-K10 timing rows, the meta path's
    launches)."""
    from dynavsr_tpu_torch.models.video_base_model import DownscalerModel, MetaModel
    from dynavsr_tpu_torch.train.losses import make_pixel_criterion
    from dynavsr_tpu_torch.train.meta import MetaConfig, meta_loss

    out = {}
    t0 = time.perf_counter()
    vimeo = write_vimeo_lmdb(gen, root)
    print(f"[meta] wrote {VIMEO_SEPT} septuplets of {VIMEO_LR[0] * SCALE}x"
          f"{VIMEO_LR[1] * SCALE} as a raw LMDB in {time.perf_counter() - t0:.1f} s")
    l1 = make_pixel_criterion("l1")
    # 10a, 10b: the downscalers (l1 on each run's first batch falls).
    for tag, run in DOWN_RUNS.items():
        m = train_and_resume(tag, lambda res, r=run: downscaler_opt(
            r["which"], r["niter"], r["save"], vimeo, root, resume=res),
            run["niter"], run["save"], DownscalerModel, per_update={})
        trained = trained_model(m["opt"])
        trained.feed_data(m["first_batch"])
        with torch.no_grad():
            l_end = float(l1(trained.netG(trained._batch["LQs"]), trained._batch["GT"]))
        l_pix = [r["l_pix"] for r in m["recs"]]
        check(all(math.isfinite(v) for v in l_pix), f"{tag}: l_pix {l_pix}")
        check(l_end < l_pix[0], f"{tag}: the l1 of batch 1 did not fall: {l_pix[0]} -> {l_end}")
        out[tag] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
        out[tag].update(which=run["which"], l_pix=l_pix, l_first_batch_end=l_end,
                        samples_per_s=16 / m["s_per_iter"],
                        final=f"{m['opt']['path']['models']}/{run['niter']}_G.pth")
        print(f"[meta] {tag} {run['which']} (nf 64, batch 16 x 7 x 256^2): {run['niter']} "
              f"updates in {m['run_s']:.1f} s; updates 3-{run['niter']} {m['s_per_iter']:.4f} s "
              f"each, {16 / m['s_per_iter']:.1f} samples/s; loader wait "
              f"{m['mean_data_wait_s'] * 1e3:.1f} ms an update; peak {m['peak_gib']:.2f} GiB "
              f"above the {m['held_gib']:.2f} held; l_pix {[round(v, 5) for v in l_pix]}, "
              f"batch 1 {l_pix[0]:.5f} -> {l_end:.5f}"
              f"{'; resumed bitwise' if m['resumed'] else ''}  [{smi}]")
        del trained

    # The estimator of 10c: an MFDN for the EDVR config's 5-frame windows,
    # trained like 10a on 10c's own REDS-shaped windows (10a's takes 7).
    est_m = train_and_resume("10c-E", lambda res: downscaler_opt(
        "MFDN", 2, None, reds_gt, root, frames=5, resume=res), 2, None, DownscalerModel,
        per_update={})
    est = f"{est_m['opt']['path']['models']}/2_G.pth"

    # 10c: second-order meta-training of EDVR-M.
    t_meta = time.perf_counter()
    m = train_and_resume("10c", lambda res: meta_opt(reds_gt, est, root, resume=res),
                         META_NITER, META_SAVE, MetaModel, per_update=META_LAUNCHES)
    recs = m["recs"]
    l_outer = [r["l_outer"] for r in recs]
    check(all(math.isfinite(r[k]) for r in recs for k in ("l_outer", "l_inner", "grad_norm")),
          f"10c: {recs}")
    model = trained_model(m["opt"])
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in m["first_batch"].items()}
    apply = make_model_apply("EDVR", SCALE)
    cfg = MetaConfig(inner_lr=1e-5, first_order=True)  # the same value as second order
    l_end = float(meta_loss(model.netG, dict(model.netG.named_parameters()), batch, cfg,
                            apply)[0].detach())
    check(l_end < l_outer[0], f"10c: l_outer of batch 1 did not fall: {l_outer[0]} -> {l_end}")
    out["10c"] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
    out["10c"].update(l_outer=l_outer, l_inner=[r["l_inner"] for r in recs],
                      grad_norm=[r["grad_norm"] for r in recs], l_first_batch_end=l_end,
                      samples_per_s=META_BATCH / m["s_per_iter"])
    print(f"[meta] 10c EDVR-M meta (batch {META_BATCH} x 5 x 256^2, alpha 1e-5, second order, "
          f"MFDN in the loop): {META_NITER} updates in {m['run_s']:.1f} s; updates "
          f"3-{META_NITER} {m['s_per_iter']:.4f} s each, "
          f"{META_BATCH / m['s_per_iter']:.1f} samples/s; loader wait "
          f"{m['mean_data_wait_s'] * 1e3:.1f} ms an update; peak {m['peak_gib']:.2f} GiB above "
          f"the {m['held_gib']:.2f} held; l_outer {[round(v, 5) for v in l_outer]}, batch 1 "
          f"{l_outer[0]:.5f} -> {l_end:.5f}; l_inner {[round(r['l_inner'], 5) for r in recs]}; "
          f"grad_norm {[round(r['grad_norm'], 5) for r in recs]}; resumed at {META_SAVE} "
          f"bitwise; launches an update {m['per_update']}  [{smi}]")

    # 10d: one meta update with every kernel call held against the plain
    # version, the second-order term held as a whole, K8-K10 timed.
    model.feed_data(batch)
    model.optimize_parameters()  # warm-up (builds the step)
    calls, keep = checked_calls(model.optimize_parameters, dcn, PLAIN_DCN_CALLS,
                                keep=TANGENT_KERNELS, by_shape=True)
    by_kernel = {}
    for r in calls:
        n, e = by_kernel.get(r["name"], (0, 0.0))
        by_kernel[r["name"]] = (n + 1, max(e, r["max_abs_err"] / max(r["tol"], 1e-30)))
    bad = [r for r in calls if not r["ok"]]
    print(f"[meta] 10d one meta update's kernel calls vs plain (1e-4 of the largest value): "
          f"{ {k: f'{n} calls, worst {e:.3f} of tol' for k, (n, e) in by_kernel.items()} }")
    check(not bad, f"10d: {len(bad)} calls off their plain version: {bad[:3]}")
    check({k: n for k, (n, _) in by_kernel.items()} == META_LAUNCHES,
          f"10d: calls a meta update {by_kernel}")
    out["10d"] = dict(calls=len(calls), by_kernel=by_kernel)

    rows = []
    # Each K8-K10 call size of the meta update: the inner step's pyramid
    # levels, 40 SLR frames of 16x16 (L1 and the cascade), 8x8 and 4x4.
    for name, shape in sorted(keep, key=lambda k: (TANGENT_KERNELS.index(k[0]), -k[1][2])):
        args = keep[(name, shape)]
        gd = args[-1]
        fn = {"dcn_fwd_tangent": dcn.dcn_fwd_tangent,
              "dcn_bwd_weight_tangent": dcn.dcn_bwd_weight_tangent,
              "dcn_bwd_data_tangent": dcn.dcn_bwd_data_tangent}[name]
        ref = {"dcn_fwd_tangent": dcn_fwd_tangent_ref,
               "dcn_bwd_weight_tangent": dcn_bwd_weight_tangent_ref,
               "dcn_bwd_data_tangent": dcn_bwd_data_tangent_ref}[name]
        bound_ms, bound_by, nbytes, flops = tangent_bound(name, shape, gd)
        got = fn(*args)
        want = ref(*args)
        got = [got] if torch.is_tensor(got) else [t for t in got if t is not None]
        want = [want] if torch.is_tensor(want) else [t for t in want if t is not None]
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        # Graph replays: K8 and K10's offset / mask gradients bitwise, grad x
        # (K10) and K9 by atomics within 1e-5.
        t = wrapper_times(lambda: fn(*args), bound_ms, rtol=TANGENT_RTOL[name])
        plain_ms = cuda_ms(lambda: ref(*args), reps=3, warmup=1)
        label = dcn_label("meta", shape)
        row = dict(name=name, label=label, dims=list(shape), gd=gd, dtype="float32",
                   max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, plain_ms=plain_ms, library_ms=None, **t)
        rows.append(row)
        print(f"[timing] {name:22s} {label} Gd={gd} max|err| {err:.3e}  {times_text(row)}  "
              f"plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms ({bound_by})  roofline "
              f"{row['roofline']:.1%} (kernel {row['kernel_roofline']:.1%})  [{smi}]")
    del calls, keep
    torch.cuda.empty_cache()

    def two_updates():
        for _ in range(2):
            model.feed_data(batch)
            model.optimize_parameters()
        torch.cuda.synchronize()

    prof = profile_clip(two_updates, "10c two meta updates", smi, DCN_KERNELS + TANGENT_KERNELS)
    out["10c"].update(busy_ms=prof.get("busy_ms"), idle_share=prof.get("idle_share"),
                      kernel_ms_per_update={k: v / 2 for k, v in prof.get("kernel_ms", {}).items()},
                      top=[(n[:80], ms) for n, ms in prof.get("top", [])])
    out["10d"].update(second_order_term(
        "meta 10d", model, batch, gen, (edvr_module, "deform_conv2d", deform_conv2d_ref),
        lambda n: "conv_offset_mask.weight" in n, OFFSET_STD))
    out["seconds_10c_10d"] = time.perf_counter() - t_meta
    out["vimeo_lmdb"] = vimeo
    del model
    torch.cuda.empty_cache()
    return out, rows, m["launches"]


# --------------------------------------------------------------- phase 11
# Second-order meta-training of the BatchNorm backbones at full width:
# train_DynaVSR_TOF_Vimeo90K.yml (TOFlow, 7 frames, the in-module x4
# pre-upscale, batch 8) and train_DynaVSR_DUF_Vimeo90K.yml (DUF-16L, batch
# 4), on phase 10's Vimeo90K-shaped LMDB with 10a's 7-frame MFDN as
# network_E. The running statistics are meta-trained as in JAX.
META2_RUNS = {
    "11a": dict(name="DynaVSR_TOF_Vimeo90K", batch=8, swap=(tof_module, "warp_nchw",
                                                            grid_sample_ref.warp_nchw),
                net={"which_model_G": "TOF", "nframes": 7, "pre_upscale": True}),
    "11b": dict(name="DynaVSR_DUF_Vimeo90K", batch=4,
                swap=(duf_module, "dynamic_upsampling_filter", dynamic_upsampling_filter_ref),
                net={"which_model_G": "DUF_16L", "nframes": 7}),
}
# The K11 / K12 kernel's wrapper on the meta path: T and grad flow in one launch.
WARP_TANGENT_KERNELS = ("warp_bwd_tangent",)
# Launches a meta update (remat on), counted on CPU with plain stand-ins
# (tests/test_torch_port_meta_tof.py, _duf.py): TOF 6 neighbours x 5 warps
# in 4 forwards (K4), 3 backwards of the 24 warps whose flow is not the
# level-0 zero (K5), one K11 / K12 launch each (no launch of T alone); DUF
# one filter in 4 forwards plus the filter tangent K6(x, Cf), 3 backwards.
META2_LAUNCHES = {"11a": {"warp_fwd": 120, "warp_bwd": 72, "warp_fwd_tangent": 0,
                          "warp_bwd_tangent": 24},
                  "11b": {"duf_fwd": 5, "duf_bwd": 3}}
SPY_BIAS_STD = 0.1  # SpyNet blocks' last-conv biases for 11c's off-grid term check


def meta2_opt(tag: str, gt: str, est: str, root: str, resume: str = None) -> dict:
    """train_DynaVSR_TOF_Vimeo90K.yml / train_DynaVSR_DUF_Vimeo90K.yml as
    cli/train.py derives them, from random weights (the configs'
    checkpoints are not in the repo) with network_E from `est`."""
    from dynavsr_tpu_torch.config.options import derive

    run = META2_RUNS[tag]
    opt = {
        "name": run["name"], "model": "video_meta", "scale": SCALE,
        "datasets": {"train": {"name": "Vimeo90K_meta", "mode": "meta", "dataroot_GT": gt,
                               "N_frames": VIMEO_T, "GT_size": 256, "use_shuffle": True,
                               "n_workers": 3, "batch_size": run["batch"]}},
        "network_G": dict(run["net"]),
        "network_E": {"which_model_G": "MFDN", "nf": 64},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume,
                 "pretrain_model_E": est},
        "train": {"lr_G": 1e-5, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                  "niter": META_NITER, "maml_lr_alpha": 1e-5, "maml_adapt_iter": 1,
                  "first_order": False, "pixel_criterion": "cb", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": META_SAVE},
    }
    return derive(opt, is_train=True, root=root)


def _plain_vjp(fn, x, second, grad_out, need_x):
    """The plain op's (grad x, unless not `need_x`; grad of its second
    input) on the same inputs, in fp32."""
    with torch.enable_grad():
        xr = x.detach().float().requires_grad_(need_x)
        sr = second.detach().float().requires_grad_()
        grads = torch.autograd.grad(fn(xr, sr), [xr, sr] if need_x else [sr], grad_out.float())
    return list(grads)


# The plain version of each K4-K7, K11 / K12 wrapper, on its own arguments:
# the non-None outputs in the wrapper's order.
PLAIN_BN_CALLS = {
    "warp_fwd": lambda x, flow: [grid_sample_ref.warp_nchw(x, flow)],
    "warp_bwd": lambda x, flow, g, need_x: _plain_vjp(grid_sample_ref.warp_nchw, x, flow, g,
                                                      need_x),
    "warp_fwd_tangent": lambda *a: [grid_sample_ref.warp_fwd_tangent_ref(*a)],
    "warp_bwd_tangent": lambda *a: [t for t in grid_sample_ref.warp_tangents_ref(*a)
                                    if t is not None],
    "duf_fwd": lambda x, f: [dynamic_upsampling_filter_ref(x, f)],
    "duf_bwd": lambda x, f, g, need_x: _plain_vjp(dynamic_upsampling_filter_ref, x, f, g,
                                                  need_x),
}


def warp_tangent_bound(shape, need_t, need_g, need_x=False):
    """(bound_ms, bound_by, bytes, flops) of one fp32 call of the K11 / K12
    kernel on (B, C, H, W) frames with the outputs asked for: each input
    read once, each output written once. It reads x, the flow and its
    tangent (C + 4 values a pixel), grad_out with grad flow (C); it writes
    T (C), grad flow (2) and grad x (C). Operations: ~12 a pixel for the
    position and weights, then 13 a channel for T, 5 for grad flow and 24
    for grad x."""
    b, c, h, w = shape
    px = b * h * w
    vals = c + 4 + (c if need_t else 0) + (c + 2 if need_g else 0) + (c if need_x else 0)
    flops = px * (12 + c * (13 * need_t + 5 * need_g + 24 * need_x))
    nbytes = px * vals * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[torch.float32] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def warp_tangent_against_plain(label, x, flow, cflow, cot):
    """Phase 3's check of the K11 / K12 kernel against the plain formulas
    (ops/grid_sample_ref.py) in each of its modes: T alone
    (warp_fwd_tangent), then grad flow, and grad flow + grad x, each
    without and with T in the same launch (warp_bwd_tangent). T within 1e-5
    of the largest reference value (the same products), the gradients 1e-4
    (a sum over channels; grad x by atomics)."""
    shape = tuple(x.shape)
    # (what, wrapper, its arguments, the tolerance of each output in order)
    modes = [("T", warp.warp_fwd_tangent, (x, flow, cflow), [1e-5])]
    for need_x in (False, True):
        for need_t in (False, True):
            what = "grad flow" + (" + grad x" if need_x else "") + (" + T" if need_t else "")
            modes.append((what, warp.warp_bwd_tangent, (x, flow, cot, cflow, need_x, need_t),
                          [1e-4] * (1 + need_x) + [1e-5] * need_t))
    for what, fn, args, tols in modes:
        out = fn(*args)
        got = [out] if torch.is_tensor(out) else [t for t in out if t is not None]
        torch.cuda.synchronize()
        want = PLAIN_BN_CALLS[fn.__name__](*args)
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        limits = [tol * float(w.abs().max()) for tol, w in zip(tols, want)]
        ok = len(got) == len(want) == len(tols) and all(e <= m for e, m in zip(errs, limits))
        print(f"[kernel] {fn.__name__:16s} {label} {shape} fp32 {what}: max|err| "
              f"{', '.join(f'{e:.3e} (tol {m:.3e})' for e, m in zip(errs, limits))} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{fn.__name__} {label} {shape} {what}: {errs} > {limits}")


def tangent_timing_row(args, smi: str) -> dict:
    """The K11 / K12 kernel on the inputs of its largest call in a TOF meta
    update (warp_bwd_tangent with the modes that call asked for): checked
    again, timed (wrapper_times) beside the plain formulas and the bound.
    No single PyTorch call computes these functions."""
    name, fn, plain = "warp_bwd_tangent", warp.warp_bwd_tangent, PLAIN_BN_CALLS["warp_bwd_tangent"]
    need_x, need_t = bool(args[4]), bool(args[5])
    got = [t for t in fn(*args) if t is not None]
    want = plain(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    shape = tuple(args[0].shape)
    bound_ms, bound_by, nbytes, flops = warp_tangent_bound(shape, need_t, True, need_x)
    rtol = [1e-5] * len(want) if need_x else 0.0
    t = wrapper_times(lambda: fn(*args), bound_ms, rtol=rtol)
    plain_ms = cuda_ms(lambda: plain(*args), reps=5)
    label = warp_label("meta", shape)
    row = dict(name=name, label=label, dims=list(shape), dtype="float32", need_x=need_x,
               need_t=need_t, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
               bytes=nbytes, flops=flops, plain_ms=plain_ms, library_ms=None, **t)
    print(f"[timing] {name:16s} {label}{' +T' if need_t else ''}{' +grad x' if need_x else ''} "
          f"max|err| {err:.3e}  {times_text(row)}  plain {plain_ms:.4f} ms  library none  "
          f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB)  roofline "
          f"{row['roofline']:.1%} (kernel {row['kernel_roofline']:.1%})  [{smi}]")
    return row


KINK_DRAWS = 16  # SpyNet bias draws of 11d's probe


def warp_terms(fn, x, flow, g, v):
    """The warp's first-order term, grad flow of <g, warp(x, flow)>, and its
    second-order term along v, the gradient in (x, flow) of <grad flow, v>
    (K4 / K5, then K11 / K12 through the port's Function; the plain warp's
    double autograd otherwise), each flattened."""
    with torch.enable_grad():
        xr, fr = x.detach().requires_grad_(), flow.detach().requires_grad_()
        (gf,) = torch.autograd.grad((fn(xr, fr) * g).sum(), fr, create_graph=True)
        tx, tf = torch.autograd.grad((gf * v).sum(), [xr, fr])
    return gf.detach().flatten(), torch.cat([tx.flatten(), tf.flatten()])


def kink_probe(model, batch, gen: torch.Generator) -> dict:
    """11d, ROADMAP C's probe of the fp32 second-order term: over
    KINK_DRAWS draws of SpyNet's last-conv biases N(0, SPY_BIAS_STD) (11c's
    redraw), every warp call of TOF's forward on one LR window, recorded;
    on each, the warp's first- and second-order terms along random (g, v)
    (warp_terms) from the plain warp in fp32, from the kernels (K4 / K5 /
    K11 / K12) in fp32, and from the plain warp in float64 on the same
    inputs: each fp32 term's distance to the float64 one (relative norm
    over the draw's calls), beside the share of sample coordinates (pixel +
    flow, in float64) that lie exactly on a bilinear kink (an integer) and
    that lie within one fp32 ulp of one without being on it (where fp32
    rounding can move the sample across the kink). The weights are
    restored after. Reported, not checked."""
    redrawn = {n: p for n, p in model.netG.named_parameters()
               if n.startswith("spynet.block") and n.endswith("conv4.bias")}
    own = {n: p.detach().clone() for n, p in redrawn.items()}
    apply, lr = make_model_apply("TOF", SCALE), batch["LR"][:1]
    eps = torch.finfo(torch.float32).eps
    calls, rows = [], []

    def recording(x, flow):
        calls.append((x.detach(), flow.detach()))
        return warp.warp_nchw(x, flow)

    t0 = time.perf_counter()
    try:
        for d in range(KINK_DRAWS):
            with torch.no_grad():
                for p in redrawn.values():
                    p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * SPY_BIAS_STD)
            calls.clear()
            tof_module.warp_nchw = recording
            try:
                with torch.no_grad():
                    apply(model.netG, lr)
            finally:
                tof_module.warp_nchw = warp.warp_nchw
            sq = dict.fromkeys(("g64", "t64", "gp", "tp", "gk", "tk"), 0.0)
            on = near = n = 0
            for x, flow in calls:
                g = torch.randn(x.shape, generator=gen, device=x.device)
                v = torch.randn(flow.shape, generator=gen, device=x.device)
                g64, t64 = warp_terms(grid_sample_ref.warp_nchw, x.double(), flow.double(),
                                      g.double(), v.double())
                for tag, fn in (("p", grid_sample_ref.warp_nchw), ("k", warp.warp_nchw)):
                    g32, t32 = warp_terms(fn, x, flow, g, v)
                    sq["g" + tag] += float((g32.double() - g64).square().sum())
                    sq["t" + tag] += float((t32.double() - t64).square().sum())
                sq["g64"] += float(g64.square().sum())
                sq["t64"] += float(t64.square().sum())
                for pos in grid_sample_ref.flow_grid(flow.double()):
                    dist = (pos - pos.round()).abs()
                    on += int((dist == 0).sum())
                    near += int(((dist > 0) & (dist <= eps * pos.abs().clamp(min=1.0))).sum())
                    n += pos.numel()
            rows.append(dict(draw=d, calls=len(calls), coords=n, on_kink=on / n,
                             near_kink=near / n,
                             grad_plain_vs_f64=math.sqrt(sq["gp"] / sq["g64"]),
                             grad_kernel_vs_f64=math.sqrt(sq["gk"] / sq["g64"]),
                             term_plain_vs_f64=math.sqrt(sq["tp"] / sq["t64"]),
                             term_kernel_vs_f64=math.sqrt(sq["tk"] / sq["t64"])))
    finally:
        with torch.no_grad():
            for name, p in redrawn.items():
                p.copy_(own[name])
    secs = time.perf_counter() - t0

    def span(key):
        vals = [r[key] for r in rows]
        return f"{min(vals):.2e}-{max(vals):.2e}"

    print(f"[meta2] 11d kink probe, {KINK_DRAWS} SpyNet bias draws x {rows[0]['calls']} warp "
          f"calls of one LR window ({rows[0]['coords']} sample coordinates a draw): on a kink "
          f"{span('on_kink')}, within one fp32 ulp of one {span('near_kink')}; vs float64, "
          f"second-order term plain {span('term_plain_vs_f64')}, kernels "
          f"{span('term_kernel_vs_f64')}; first-order plain {span('grad_plain_vs_f64')}, "
          f"kernels {span('grad_kernel_vs_f64')}; {secs:.1f} s")
    return dict(rows=rows, seconds=secs)


def phase_meta2(smi: str, gen: torch.Generator, vimeo: str, est: str, root: str) -> tuple:
    """11a-11d; returns (measurements, the K11 / K12 timing row, 11a's launches)."""
    from dynavsr_tpu_torch.models.video_base_model import MetaModel
    from dynavsr_tpu_torch.train.meta import MetaConfig, meta_loss, meta_variables

    out, rows, launches = {}, [], None
    for tag, run in META2_RUNS.items():
        t_run = time.perf_counter()
        expect = META2_LAUNCHES[tag]
        m = train_and_resume(tag, lambda res, tag=tag: meta2_opt(tag, vimeo, est, root, res),
                             META_NITER, META_SAVE, MetaModel, per_update=expect)
        recs = m["recs"]
        l_outer = [r["l_outer"] for r in recs]
        check(all(math.isfinite(r[k]) for r in recs for k in ("l_outer", "l_inner", "grad_norm")),
              f"{tag}: {recs}")
        model = trained_model(m["opt"])
        arch = model.netG.arch
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in m["first_batch"].items()}
        leaves = {k: t.detach().requires_grad_()
                  for k, t in meta_variables(model.netG).items()}
        cfg = MetaConfig(inner_lr=1e-5, first_order=True)  # the same value as second order
        l_end = float(meta_loss(model.netG, leaves, batch, cfg,
                                make_model_apply(arch, SCALE))[0].detach())
        check(l_end < l_outer[0],
              f"{tag}: l_outer of batch 1 did not fall: {l_outer[0]} -> {l_end}")
        # The running statistics start at torch's 0 / 1 and move only by
        # the meta updates (every forward of the path runs in eval mode).
        stats = {k: v for k, v in model.netG.state_dict().items() if k.endswith(("running_mean",
                                                                                  "running_var"))}
        moved = {k: float((v - (0.0 if k.endswith("mean") else 1.0)).abs().max())
                 for k, v in stats.items()}
        check(stats and all(v > 0 for v in moved.values()),
              f"{tag}: running statistics that did not move: "
              f"{[k for k, v in moved.items() if v == 0][:5]}")
        out[tag] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
        out[tag].update(l_outer=l_outer, l_inner=[r["l_inner"] for r in recs],
                        grad_norm=[r["grad_norm"] for r in recs], l_first_batch_end=l_end,
                        samples_per_s=run["batch"] / m["s_per_iter"], stats=len(stats),
                        stats_moved_min=min(moved.values()), stats_moved_max=max(moved.values()))
        print(f"[meta2] {tag} {arch} meta (batch {run['batch']} x 7 x 256^2, alpha 1e-5, second "
              f"order, MFDN in the loop): {META_NITER} updates in {m['run_s']:.1f} s; updates "
              f"3-{META_NITER} {m['s_per_iter']:.4f} s each, "
              f"{run['batch'] / m['s_per_iter']:.2f} samples/s; loader wait "
              f"{m['mean_data_wait_s'] * 1e3:.1f} ms an update; peak {m['peak_gib']:.2f} GiB "
              f"above the {m['held_gib']:.2f} held; l_outer {[round(v, 5) for v in l_outer]}, "
              f"batch 1 {l_outer[0]:.5f} -> {l_end:.5f}; {len(stats)} running statistics moved "
              f"{min(moved.values()):.2e}-{max(moved.values()):.2e}; resumed at {META_SAVE} "
              f"bitwise with them; launches an update {m['per_update']}  [{smi}]")
        if tag == "11a":
            launches = m["launches"]

        # 11c: one meta update with every kernel call held against its plain
        # version, the second-order term as a whole, the K11 / K12 launch timed.
        module = warp if arch == "TOF" else duf_filter
        names = tuple(expect)
        model.feed_data(batch)
        model.optimize_parameters()  # warm-up (builds the step)
        calls, keep = checked_calls(model.optimize_parameters, module,
                                    {n: PLAIN_BN_CALLS[n] for n in names},
                                    keep=WARP_TANGENT_KERNELS)
        by_kernel = {}
        for r in calls:
            n, e = by_kernel.get(r["name"], (0, 0.0))
            by_kernel[r["name"]] = (n + 1, max(e, r["max_abs_err"] / max(r["tol"], 1e-30)))
        bad = [r for r in calls if not r["ok"]]
        worst = {k: f"{n} calls, worst {e:.3f} of tol" for k, (n, e) in by_kernel.items()}
        print(f"[meta2] 11c {arch}: one meta update's kernel calls vs plain (1e-4 of the "
              f"largest value): {worst}")
        check(not bad, f"11c {arch}: {len(bad)} calls off their plain version: {bad[:3]}")
        called = {k: n for k, n in expect.items() if n}  # a count of 0: no call to check
        check({k: n for k, (n, _) in by_kernel.items()} == called,
              f"11c {arch}: calls a meta update {by_kernel}")
        out[tag]["calls"] = {k: list(v) for k, v in by_kernel.items()}
        if arch == "TOF":
            rows.append(tangent_timing_row(keep["warp_bwd_tangent"], smi))
        del calls, keep
        torch.cuda.empty_cache()

        def two_updates():
            for _ in range(2):
                model.feed_data(batch)
                model.optimize_parameters()
            torch.cuda.synchronize()

        prof = profile_clip(two_updates, f"{tag} two meta updates", smi, names)
        out[tag].update(busy_ms=prof.get("busy_ms"), idle_share=prof.get("idle_share"),
                        kernel_ms_per_update={k: v / 2 for k, v in
                                              prof.get("kernel_ms", {}).items()},
                        top=[(n[:80], ms) for n, ms in prof.get("top", [])])
        redraw = (lambda n: n.startswith("spynet.block") and n.endswith("conv4.bias")) \
            if arch == "TOF" else None
        # On 2 windows a try, so that the float64 gauge stays cheap.
        tries = 3 if arch == "TOF" else 2
        term_batch = batch if arch == "DUF" else {k: v[:2] for k, v in batch.items()}
        out[tag]["term"] = second_order_term(f"meta2 11c {arch}", model, term_batch, gen,
                                             run["swap"], redraw, SPY_BIAS_STD, tries=tries)
        if arch == "TOF":
            out[tag]["kink_probe"] = kink_probe(model, batch, gen)
        out[tag]["seconds"] = time.perf_counter() - t_run
        del model
        torch.cuda.empty_cache()
    return out, rows, launches

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
    t_surface = time.perf_counter()
    surface = phase_surface(smi, gen, lq, duf_lq)
    surface["seconds"] = time.perf_counter() - t_surface
    print(f"[surface] phase 8 took {surface['seconds']:.1f} s")
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as root:
        t_train = time.perf_counter()
        reds_gt, reds_lq = write_train_lmdbs(gen, root)
        print(f"[train] wrote {len(TRAIN_CLIPS)} clips x {TRAIN_T} frames of "
              f"{REDS_H * SCALE}x{REDS_W * SCALE} GT / {REDS_H}x{REDS_W} LQ as raw LMDBs in "
              f"{time.perf_counter() - t_train:.1f} s")
        training, train_rows = phase_train(smi, reds_gt, reds_lq, root)
        training["seconds"] = time.perf_counter() - t_train
        print(f"[train] phase 9 took {training['seconds']:.1f} s")
        t_meta = time.perf_counter()
        meta, meta_rows, meta_launches = phase_meta(smi, gen, reds_gt, root)
        meta["seconds"] = time.perf_counter() - t_meta
        print(f"[meta] phase 10 took {meta['seconds']:.1f} s")
        t_meta2 = time.perf_counter()
        meta2, meta2_rows, meta2_launches = phase_meta2(smi, gen, meta["vimeo_lmdb"],
                                                        meta["10a"]["final"], root)
        meta2["seconds"] = time.perf_counter() - t_meta2
        print(f"[meta2] phase 11 took {meta2['seconds']:.1f} s")
    rows += train_rows + meta_rows + meta2_rows
    # Each kernel's launches are those of the path that runs it (counts set
    # to 0 just before that path and read just after).
    launches = {**{k: edvr_launches[k] for k in DCN_KERNELS},
                **{k: tof_launches[k] for k in WARP_KERNELS},
                **{k: duf_launches[k] for k in DUF_KERNELS},
                **{k: meta_launches[k] for k in TANGENT_KERNELS},
                **{k: meta2_launches[k] for k in WARP_TANGENT_KERNELS}}

    kernels = []
    for name, (source, label, replaces) in KERNELS.items():
        row = next(r for r in rows if r["name"] == name and r["label"] == label
                   and r["dtype"] == "float32" and r.get("run", "fp32") == "fp32")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row.get("library_ms")})
        if "kernel_ms" in row:  # K4-K12: the device time of a launch, the host's of a call
            kernels[-1].update({k: row[k] for k in ("kernel_ms", "host_us", "kernel_roofline")})
        if name in DCN_KERNELS + DUF_KERNELS:  # the bf16 call of the same kind
            r16 = next(r for r in rows if r["name"] == name and r["label"] == label
                       and r["dtype"] == "bfloat16")
            kernels[-1].update(ms_bf16=r16["ms"], bound_ms_bf16=r16["bound_ms"],
                               max_abs_err_bf16=r16["max_abs_err"])
            if "kernel_ms" in r16:
                kernels[-1].update(kernel_ms_bf16=r16["kernel_ms"], host_us_bf16=r16["host_us"])
        if name in DCN_KERNELS:  # phase 9: the L1 call of a training update, 9a and 9b
            for tag, suffix in (("9a", ""), ("9b", "_bf16")):
                rt = next(r for r in train_rows if r["name"] == name and r["run"] == tag
                          and "ms" in r and r["dims"][2] == 64)
                kernels[-1].update({f"train_ms{suffix}": rt["ms"],
                                    f"train_plain_ms{suffix}": rt["plain_ms"],
                                    f"train_bound_ms{suffix}": rt["bound_ms"],
                                    f"train_launches{suffix}": training[tag]["launches"][name]})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": rows, "main": main_results, "tof": tof_results,
                       "duf": duf_results, "surface": surface, "train": training,
                       "meta": meta, "meta2": meta2,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print("[train] " + json.dumps(training))
    print("[meta] " + json.dumps(meta, default=str))
    print("[meta2] " + json.dumps(meta2, default=str))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
