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
              256x256), white-noise flows N(0, 4^2) px and tangents;
              K8 dcn_fwd_tangent, K9 dcn_bwd_weight_tangent and K10
              dcn_bwd_data_tangent against ops/dcn_ref.py's *_tangent_ref
              in fp32 (1e-4) and bf16 (against the formulas with bf16
              tangent columns and weights, K1-K3's bf16 bounds: K8 2^-8,
              K9 / K10 2^-8 + 1e-4) at the meta inner steps' calls, Gd 8:
              EDVR-M's 40 x 64 x {16, 8, 4}^2 (10c) and EDVR-L's 10 x 128
              x {8, 4, 2}^2 (15c) (correctness checks, not timed);
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
              of the gradient, gauged against float64 (gauge_verdict), with
              the meta loss's Charbonnier eps at 1e-4 (TERM_CB_EPS; the
              configs' 1e-12 reading is reported), for TOF with SpyNet's last-conv biases
              redrawn N(0, 0.1) so the flows sit off the pixel grid (the
              trained weights' reading is reported too); the K11 / K12
              launch timed on the inputs of its largest call. 11d (TOF): over 16 draws of
              SpyNet's last-conv biases, the warp's first- and second-order
              terms on every warp call of one LR window's forward, plain
              warp and K4 / K5 / K11 / K12 in fp32 against the plain warp
              in float64, beside the share of samples on and within one
              fp32 ulp of a bilinear kink (reported, not checked). Prints a
              `[meta2] {json}` line.
 12. tiles    tiled inference (eval/tiled.py; every tile of a call's windows
              in one batch, as in JAX): 12a test_DynaVSR_Vid4.yml's EDVR-M x4
              + MFDN through run_clip on a 7-frame smooth clip at LR 540x960
              (-> 2160x3840), adapted on its 7 windows, then whole-frame at
              infer_chunk 1, eval.tile 256 / overlap 32 at infer_chunk 1 and
              2: s/clip, frames/s and peak memory of each run, and one
              forward of a chunk alone (s a frame, its own peak memory),
              K1 = 4 a forward call + 20, max |tiled - whole| and the PSNR between them
              (EDVR is not tile-exact: reported, finiteness checked), one K1
              call on the tile batch (75 frames of 256^2) against the plain
              DCN at phase 3's tolerance; 12b DUF-16L fp32 on phase 6's
              windows, tile 64 / overlap 12: tiled == whole within 1e-4;
              12c create_model's make_infer_fn with eval.tile 128 / overlap
              32 on 8a's clip and weights: max |tiled - 8a| reported, K1 as
              counted, make_seq_infer_fn None. Prints a `[tiles] {json}` line.
 13. stream   online serving (eval/streaming.py) of phases 4-6's nets: 13a
              StreamingSR EDVR-M + the MFDN adapter (K 8, 5 Adam steps, lr
              1e-6) on phase 4's clip, fp32 == phase 4's window-batched
              run_clip within 1e-4 (bf16: the gap printed beside phase 4's
              windows-vs-seq gap); 13b WindowStreamSR TOF and DUF-16L with
              the train_ema adapter on phases 5 / 6's clips, == their
              run_clip within 1e-4; 13c MultiStreamSR B = 4 EDVR-M fp32 on
              four clips of other seeds, shared and adapted in G = 1 / 2 / 4
              groups, each stream == its reference construction within 1e-4.
              Checks a steady EDVR push launches K1 4 times (TOF K4 30, DUF
              K6 1) and an EDVR warm-up K2 = K3 = 20. Reports the warm-up
              push's s, steady ms/frame (median over emitting pushes, the
              card synchronised around each), host us a push until push()
              returns, ms/frame/stream for each G, peak memory, and one
              steady push under utils/observability.profile_trace (busy /
              idle share, top operations), as a `[stream] {json}` line.
 14. multi    multi-device (parallel/mesh.py, one process a card) on the one
              card: 14a cli/test_dynavsr.run_clips (clip-parallel) at world
              size 1, a NCCL group made by init_dist, of phase 4's EDVR-M +
              MFDN on 5 clips of other seeds in two resolution buckets
              (144x176: 16, 16, 7 frames; 120x180: 16, 12), window-batched
              and sequence mode, fp32: each clip == run_clip within 1e-4
              (the 7-frame clip, shorter than the 8 adaptation windows: ==
              the per-clip path fed batch_clips' window choice), K1-K3 as
              counted, every kind of K1-K3 call against the plain DCN, s for
              the set against the serial run_clip loop; 14b the same at 2
              spawned ranks sharing the card over gloo (NCCL refuses two
              ranks on one device): each clip == 14a's within 1e-4, rank 0
              holding every clip's scores, launches a rank as counted; 14c
              one supervised step (9a's config, global batch 32, 16 a rank)
              and 14d one second-order meta step (10c's, global batch 8, 4 a
              rank) through cli/train.train at 2 ranks: the ranks' weights
              bitwise equal after the step; the all-reduced gradient against
              the one-process gradient on the same global batch (relative
              norm) within 4 x the distance at which splitting the batch in
              two puts the one-process gradient (fp32 order, amplified where
              DCN samples cross bilinear kinks) + 1e-5, and (14c) within
              1e-5 of that one-process split gradient; the launches a rank;
              every K1-K3 (K8-K10) call against the plain version, each call
              shape timed on rank 0. Prints a `[multi] {json}` line.
 15. edvr_l   EDVR-L (train_EDVR_L_REDS.yml's network_G: nf 128, 5 frames,
              Gd 8, 5 + 40 blocks, TSA, bf16) through the entry points,
              random weights from the seed: 15a run_clip adapt-and-infer on
              phase 4's clip with phase 4's MFDN (s/clip, peak memory; K1-K3
              launches equal to phase 4's bf16 EDVR-M clip's); 15b
              cli/train.train with train_EDVR_L_REDS.yml's fields on phase
              9's REDS LMDB, 3 updates at the global batch 32 (K1 = K2 = K3
              = 4 an update); 15c second-order meta-training through
              cli/train.train (cli/train_dynavsr's path) with
              train_DynaVSR_EDVR_REDS.yml's fields and EDVR-L's network_G at
              tools/edvr_l_step_check.py's shapes (batch 2, GT 128: SLR 8,
              LR 32, HR 128), 10c's 5-frame MFDN in the loop, 3 updates
              resumed from update 2 bitwise; 15d 10c's EDVR-M and 11b's
              DUF-16L meta-trained in bf16 (4 updates each), s/update beside
              phases 10 / 11's fp32 figures. In 15c and 15d: the launches
              of every update equal the CPU counts (K1 28, K2 24, K3 20,
              K8-K10 4; DUF K6 5, K7 3); every kernel call of one update
              against its plain version in bf16 (phase 3's bf16 bounds;
              DUF's grad filters 2^-7); the bf16 second-order term of the
              meta gradient, at the first alpha in 1e-3..1000 where the
              float64 term is at least half the gradient (below that the
              bf16 terms' own rounding swamps them), gauged against that
              float64 evaluation of the plain ops (second_order_term: the
              kernels' term within 4 x the plain bf16 term's distance from
              float64 + 0.1, a bf16 gradient's own distance), offsets
              redrawn N(0, 0.05) for EDVR, with the meta loss's Charbonnier
              eps at 1e-4 (at the configs' 1e-12 its curvature near a zero
              residual makes the bf16 term a lottery of which pixels
              rounding puts there; that reading is reported); the bf16 K8-K10 calls of a 15c
              update timed (the kernels line's bf16 entries). Prints an
              `[edvr_l] {json}` line.
 16. quality  the blind-adaptation quality protocol
              (dynavsr_tpu_torch/tools/blind_adaptation_check.py) through
              its functions at the JAX tool's toy-shape leg: EDVR nf 32, 2 +
              3 blocks, Gd 8, bf16 nets, seed 0, iso:1.8, 600 supervised +
              600 MFDN iterations, 20 adaptation steps at lrs 1e-6 and 1e-5,
              on raw-byte LMDBs it writes; run with a 150-iteration
              second-order meta leg (checked: the protocol's PASS, mean gain
              > 0.05 dB), then with none from the same root (the trained
              nets reused, the tests run again), each gain printed beside
              JAX's record (3.94 dB, matched bicubic 38.52 dB). At
              trained weights: every K1-K3 call of one adapted clip of the
              iso1.8 leg and every K1-K3, K8-K10 call of one meta update
              held against the plain version (call_tol's bf16 bounds; a
              call past its bound held if the kernel is no farther from a
              float64 evaluation than the plain version plus the bound),
              each kernel's spread of error / bound, the K1 offsets' mean
              |value| in px, and the largest call of each timed and read
              beside a wrong kernel (the plain version with offsets 2^-6
              px off: how far past both checks it lands; the kernels
              line's `*_trained_*` entries). Then the TOF and DUF legs
              (--arch tof / duf, the same flags, meta 150 only, bn_mode
              auto = train_ema): PASS checked, each gain printed beside
              JAX's record (TOF 2.48 dB under train_ema, DUF 3.56 dB);
              every K4 / K5 / K12 (K6 / K7) call of one adapted clip and
              of one meta update at trained weights held against the plain
              version and gauged against float64 the same way (every
              launch is one checked call), K12 also on each of that
              update's K5 calls' inputs with a drawn flow cotangent (at
              the trained weights its own are mostly all zero) and on
              the meta leg's first 256 launches, the trained flows' mean
              |value| in px and share off the frame, and the largest call
              of each timed beside its plain version, its library call and
              its bound. Prints a
              `[quality] {json}` line. A script that calls phase_device and
              phase_build can run phase_quality, or one backbone's leg
              (quality_bn_leg), alone.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import math
import os
import os.path as osp
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import torch

import torch.nn.functional as F

from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig, chunked_apply, make_adapt_fn
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator, run_clip
from dynavsr_tpu_torch.data.degradations import duf_downsample
from dynavsr_tpu_torch.data.resize import imresize
from dynavsr_tpu_torch.data.windows import all_windows, index_generation
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.convert_img import tensor2img
from dynavsr_tpu_torch.eval.harness import evaluate_dataset, score_frames
from dynavsr_tpu_torch.eval.metrics import calculate_psnr
from dynavsr_tpu_torch.eval.streaming import (
    MultiStreamSR,
    StreamingSR,
    WindowStreamSR,
    make_streaming_adapter,
)
from dynavsr_tpu_torch.eval.tiled import make_tiled_apply, tile_plan
from dynavsr_tpu_torch.models import duf as duf_module
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.models import tof as tof_module
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
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
from dynavsr_tpu_torch.utils.observability import profile_trace
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


# K8-K10's calls in a meta update's inner step, Gd 8: EDVR-M's (10c: 40 SLR
# frames x 64 channels at the pyramid's 16x16, 8x8 and 4x4) and EDVR-L's (15c:
# 10 frames x 128 channels at 8x8, 4x4 and 2x2).
META_TANGENT_SHAPES = ((40, 64, 16, 16), (40, 64, 8, 8), (40, 64, 4, 4), (10, 128, 8, 8),
                       (10, 128, 4, 4), (10, 128, 2, 2))


def tangent_against_plain(shape, gd, dtype, gen) -> None:
    """K8-K10 against their plain formulas on the same inputs (white-noise
    offsets as dcn_inputs', N(0, 1) offset cotangents and grad_out), x
    channels-last as the autograd hands it over; call_tol's bounds (fp32
    1e-4; bf16 against the formulas with bf16 tangent columns and
    weights)."""
    x, offset, mask, weight, _, _ = dcn_inputs(shape, gd, dtype, gen)
    cot = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    coff = torch.randn(offset.shape, generator=gen, device="cuda").to(dtype)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    args = {"dcn_fwd_tangent": (x_cl, offset, mask, weight, coff, gd),
            "dcn_bwd_weight_tangent": (x_cl, offset, mask, cot, coff, gd),
            "dcn_bwd_data_tangent": (x_cl, offset, mask, weight, cot, coff, gd)}
    label = dcn_label("meta", shape)
    for name, a in args.items():
        out = getattr(dcn, name)(*a)
        got = [out] if torch.is_tensor(out) else [t for t in out if t is not None]
        want = PLAIN_DCN_CALLS[name](*a)
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        tol = call_tol(name, a) * max(float(w.abs().max()) for w in want)
        ok = len(got) == len(want) and all(g.dtype == dtype for g in got) and err <= tol
        line = (f"{name:22s} {label} Gd={gd} {str(dtype)[6:]:8s} max|err| {err:.3e} "
                f"(tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        print(f"[kernel] {line}")
        check(ok, line)


def phase_kernels() -> None:
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in META_TANGENT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            tangent_against_plain(shape, 8, dtype, gen)
    torch.cuda.empty_cache()
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
    # Phase 13 serves the same nets and holds its streams against these clips.
    ctx = dict(vsr32=vsr32, vsr16=vsr16, est=est, d16=d16,
               sr={dt: results[f"{dt}-windows"]["sr"] for dt in ("fp32", "bf16")})
    return launches, {k: {kk: vv for kk, vv in v.items() if kk != "sr"}
                      for k, v in results.items()}, profiles, calls, ctx


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
            launches, ctx = counts, dict(net=model, est=est, sr=sr)
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
    return launches, results, profiles, calls, ctx


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


def device_events(prof) -> list:
    """A profiler's device events with a duration: kernels and copies."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
            and not getattr(e, "is_user_annotation", False)]


def busy_us(events) -> float:
    """The length of the union of the events' time ranges."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


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
    events, by_name, n_by_name = device_events(prof), {}, {}
    launches = {k: [] for k in sized}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
        for k in sized:
            if f"{k}_kernel" in e.name:
                launches[k].append((e.time_range.start, e.time_range.elapsed_us()))
    if not events:
        print(f"[profile] {mode}: the profiler recorded no device events (not measured)")
        return {}
    busy = busy_us(events)
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
    # 12c tiles 8a's fp32 path on 8a's clip (popped by main before the JSON).
    out["_8a"] = dict(lq=reds_lq, state=copy.deepcopy(models["fp32"].netG.state_dict()),
                      sr=srs["fp32-windows"])
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
            "n_workers": 3, "batch_size": run.get("batch", 32), "GT_size": 256, "LQ_size": 64,
            "use_flip": True, "use_rot": True}},
        "network_G": {**run.get("net", EDVR_M), "groups": run["groups"], "predeblur": False,
                      "HR_in": False, **({"dtype": run["dtype"]} if run["dtype"] else {})},
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
# recomputed twice under remat), in fp32 and bf16: the count the CPU tests
# test_torch_port_meta.py::test_meta_update_launches_with_the_kernel_stand_ins
# and test_torch_port_bf16_second_order.py hold.
META_LAUNCHES = {"dcn_fwd": 28, "dcn_bwd_data": 24, "dcn_bwd_weight": 20,
                 "dcn_fwd_tangent": 4, "dcn_bwd_weight_tangent": 4, "dcn_bwd_data_tangent": 4}
# Searched for an alpha whose second-order term is >= 5 % of the meta
# gradient: there the kernels' fp32 differences from the plain DCN in the
# whole gradient (measured up to 6e-5 of it) stay far below the check's
# 1e-2 of the term.
ALPHAS = (1e-3, 1e-2, 1e-1, 1.0, 10.0)
TERM_SHARE = 5e-2
# Phase 11's term checks (second_order_term, gauge_verdict): on every try the
# kernels' fp32 term lies within GAUGE_FACTOR times the plain op's fp32
# distance from the float64 term, plus GAUGE_FLOOR (relative norms); the
# kernels-vs-plain check is held on the tries whose fp32 plain term is within
# GAUGE of the float64 one. On an ill-conditioned draw both fp32 terms sit
# about equally far from float64 (11d), so only the kernels' own distance fails.
# The plain op's distance is read twice: on the batch, and on the batch with
# every value moved by about one fp32 ulp (JITTER), because one fp32 draw of
# an ill-conditioned term may land near float64 by chance (DUF's 11c: the
# plain term 2.6e-4 from float64 on one batch, the kernels' 1.1e-2, both fp32
# terms 2e-2-2e-1 from it on the other tries; PERF.md §6).
GAUGE = 1e-3
GAUGE_FACTOR, GAUGE_FLOOR = 4.0, 1e-3
JITTER = 2.0 ** -23
# The meta loss of the term checks (11c, 15c / 15d): Charbonnier with eps
# 1e-4 (its curvature at most 1e2) in place of the configs' 1e-12 (up to 1e6
# where a residual is within 1e-5 of zero). The inner step's Hessian carries
# that curvature, so at 1e-12 the term is dominated by whichever few pixels
# a path's rounding puts next to zero, and it moves with the input itself:
# on the card, EDVR-L's bf16 term read 0.16-0.17 from float64 for the
# kernels and the plain op alike on 4 of 5 draws and 24 for the kernels on
# the fifth (every kernel call of it within its tolerance), at 1e-4 all 5
# read 0.026-0.029 for both. 11c's fp32 terms likewise: at 1e-12 TOF's read
# 3e-4-1.7e-1 from float64 for both, and once 4.3e-2 for the kernels where
# two plain draws read 1.0e-3 (every K4 / K5 / K12 call of that update
# within its tolerance); over 4 runs of TOF and DUF
# (tools/meta2_term_repeats.py) the plain op read 2.7e-4-3.4e-1 and the
# kernels 1.2e-4-1.7e-1 at 1e-12, and at 1e-4 every first try held: both
# plain draws 4e-6-3e-4 from float64, the kernels 4e-6-1.8e-4. The configs'
# loss is read beside it and reported.
TERM_CB_EPS = 1e-4


@contextlib.contextmanager
def meta_charbonnier(eps: float):
    """train/meta.py's losses with Charbonnier's eps set to `eps`."""
    from dynavsr_tpu_torch.train import meta as meta_module

    orig = meta_module.charbonnier_loss
    meta_module.charbonnier_loss = functools.partial(orig, eps=eps)
    try:
        yield
    finally:
        meta_module.charbonnier_loss = orig


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


def meta_opt(gt: str, est: str, root: str, resume: str = None,
             name: str = "DynaVSR_EDVR_M_REDS", net: dict = None, gt_size: int = 256,
             batch: int = META_BATCH, niter: int = META_NITER, save=META_SAVE) -> dict:
    """train_DynaVSR_EDVR_REDS.yml as cli/train.py derives it, from random
    weights (no EDVR checkpoint in the repo) with network_E from `est`;
    `net` replaces its network_G (EDVR-M), as phase 15 puts EDVR-L's in."""
    from dynavsr_tpu_torch.config.options import derive

    opt = {
        "name": name, "model": "video_meta", "scale": SCALE,
        "datasets": {"train": {"name": "REDS_meta", "mode": "meta", "dataroot_GT": gt,
                               "N_frames": 5, "GT_size": gt_size, "use_shuffle": True,
                               "n_workers": 3, "batch_size": batch}},
        "network_G": {**(net or EDVR_M), "predeblur": False, "HR_in": False},
        "network_E": {"which_model_G": "MFDN", "nf": 64},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume,
                 "pretrain_model_E": est},
        "train": {"lr_G": 1e-5, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                  "niter": niter, "maml_lr_alpha": 1e-5, "maml_adapt_iter": 1,
                  "first_order": False, "pixel_criterion": "cb", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": save or 5e3},
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


def _cd(x):
    """The plain version's compute dtype for a kernel call on x: bf16
    columns and weights for a bf16 call (the kernels' own function), else
    fp32."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else None


def _f32(*ts):
    """fp32 copies of the tensors; a float64 tensor stays float64 (the
    float64 gauge's evaluation of a plain version)."""
    return [t.float() if torch.is_tensor(t) and t.dtype != torch.float64 else t for t in ts]


def _f64(*ts):
    return [t.double() if torch.is_tensor(t) and t.is_floating_point() else t for t in ts]


def _dcn_vjp(x, offset, mask, weight, cot, gd, wrt):
    """The plain DCN's gradients in the inputs `wrt` (indices into (x,
    offset, mask, weight)), in fp32 (bf16 columns and weights for bf16
    inputs; float64 for float64 inputs)."""
    with torch.enable_grad():
        leaves = [None if t is None else _f32(t.detach())[0].requires_grad_()
                  for t in (x, offset, mask, weight)]
        out = deform_conv2d_ref(*leaves, deformable_groups=gd, compute_dtype=_cd(x))
        grads = torch.autograd.grad(out, [leaves[i] for i in wrt if leaves[i] is not None],
                                    _f32(cot)[0])
    return list(grads)


def _tangent_plain(ref):
    """A K8-K10 plain formula on a wrapper's own arguments, in fp32 (with
    bf16 tangent columns and weights for bf16 inputs; float64 for float64
    inputs); its non-None outputs."""
    def call(*args):
        out = ref(*_f32(*args), compute_dtype=_cd(args[0]))
        return [out] if torch.is_tensor(out) else [t for t in out if t is not None]
    return call


# The plain version of each K1-K3, K8-K10 wrapper, on its own arguments: the
# non-None outputs in the wrapper's order (K1's `_fwd` also returns its
# channels-last copy of x, which is not compared).
PLAIN_DCN_CALLS = {
    "_fwd": lambda x, offset, mask, weight, bias, gd: [deform_conv2d_ref(
        *_f32(x, offset, mask, weight, bias), deformable_groups=gd, compute_dtype=_cd(x))],
    "dcn_bwd_data": lambda x, offset, mask, weight, cot, gd: _dcn_vjp(
        x, offset, mask, weight, cot, gd, (0, 1, 2)),
    "dcn_bwd_weight": lambda x, offset, mask, cot, gd: _dcn_vjp(
        x, offset, mask, torch.zeros(cot.shape[1], x.shape[1], 3, 3, device=x.device,
                                     dtype=_f32(x)[0].dtype), cot, gd, (3,)),
    "dcn_fwd_tangent": _tangent_plain(dcn_fwd_tangent_ref),
    "dcn_bwd_weight_tangent": _tangent_plain(dcn_bwd_weight_tangent_ref),
    "dcn_bwd_data_tangent": _tangent_plain(dcn_bwd_data_tangent_ref),
}
# A bf16 kernel call against its plain version with bf16 columns and
# weights, relative to the plain result's largest value (phase 3's bounds):
# the final rounding (K1, K8), and the fp32 tolerance besides for the order
# in which atomics sum (K2, K3, K9, K10).
BF16_TOL = {"dcn_fwd": 2.0 ** -8, "dcn_bwd_data": 2.0 ** -8 + 1e-4,
            "dcn_bwd_weight": 2.0 ** -8 + 1e-4, "dcn_fwd_tangent": 2.0 ** -8,
            "dcn_bwd_weight_tangent": 2.0 ** -8 + 1e-4, "dcn_bwd_data_tangent": 2.0 ** -8 + 1e-4}


def call_tol(name: str, args) -> float:
    """checked_calls' bound for a call of wrapper `name`, relative to the
    plain result's largest value: 1e-4 for fp32 operands (the same fp32
    arithmetic in another order); for bf16 operands BF16_TOL (K1-K3,
    K8-K10), and for K7 with bf16 filters 2^-7 (its grad filters rounded to
    bf16, where the plain version keeps fp32: half a bf16 step, with
    margin)."""
    name = "dcn_fwd" if name == "_fwd" else name
    if not any(torch.is_tensor(a) and a.dtype == torch.bfloat16 for a in args):
        return 1e-4
    if name in BF16_TOL:
        return BF16_TOL[name]
    return 2.0 ** -7 if name == "duf_bwd" else 1e-4


def checked_calls(run, module, plain: dict, keep=(), by_shape: bool = False,
                  f64: bool = False, max_calls: int = None) -> tuple:
    """Run `run()` with every call of `module`'s wrappers named in `plain`
    held against plain[name] on the same inputs as it happens (phase 3's
    tolerances, call_tol: 1e-4 of the plain result's largest value in
    fp32); returns one row a call (a K1 row also has its offsets' mean
    |value| in px, a warp row its flow's and the share of its samples off
    the frame), and the arguments of the largest call of each wrapper in
    `keep` whose plain result is not all zero (with `by_shape`, of its
    first such call at each input shape, keyed (name, shape)). With `f64`
    every call is also gauged: plain[name] on its inputs in float64, and
    the kernel's and the plain version's largest distance from it,
    relative to the same scale (`kernel_vs_f64`, `plain_vs_f64`); a call
    past its bound against the plain version is then held by f64_held.
    With `max_calls`, the calls after the first max_calls run unchecked."""
    rows, kept = [], {}
    orig = {n: getattr(module, n) for n in plain}

    def recording(name):
        def call(*args, **kwargs):
            out = orig[name](*args, **kwargs)
            if max_calls is not None and len(rows) >= max_calls:
                return out
            args = args + tuple(kwargs.values())
            got = [out] if torch.is_tensor(out) else [t for t in out if t is not None]
            with torch.no_grad():
                want = plain[name](*args)
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.abs().max()) for w in want)
            tol = call_tol(name, args) * scale
            row = dict(name="dcn_fwd" if name == "_fwd" else name, dims=list(args[0].shape),
                       dtype=str(args[0].dtype)[6:], max_abs_err=err, tol=tol, scale=scale,
                       ok=err <= tol)
            if name == "_fwd":
                row["offset_absmean_px"] = float(args[1].detach().float().abs().mean())
            elif name.startswith("warp"):
                row.update(flow_absmean_px=float(args[1].detach().float().abs().mean()),
                           flow_off_frame=off_frame_share(args[1]))
            if f64:
                with torch.no_grad():
                    exact = plain[name](*_f64(*args))
                unit = max(scale, 1e-30)
                row.update(kernel_vs_f64=max(float((g.double() - e).abs().max())
                                             for g, e in zip(got, exact)) / unit,
                           plain_vs_f64=max(float((w.double() - e).abs().max())
                                            for w, e in zip(want, exact)) / unit)
                row["ok"] = f64_held(row)
            rows.append(row)
            key = (name, tuple(args[0].shape)) if by_shape else name
            if name in keep and scale > 0 and (key not in kept or (
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


def off_frame_share(flow: torch.Tensor) -> float:
    """The share of a (B, 2, H, W) flow's samples that land off the frame,
    in the warp's zero padding (no gradient reaches the flow there)."""
    f = flow.detach().float()
    h, w = f.shape[-2:]
    gx = torch.arange(w, device=f.device)[None, :] + f[:, 0]
    gy = torch.arange(h, device=f.device)[:, None] + f[:, 1]
    return float(((gx < 0) | (gx > w - 1) | (gy < 0) | (gy > h - 1)).float().mean())


def f64_held(row: dict) -> bool:
    """A gauged call (checked_calls with f64) holds if it is within its
    bound of the plain version, or, past it, if the kernel is no farther
    from the float64 evaluation than the plain version is plus that bound
    (both relative to the plain result's largest value). Two bf16 outputs
    rounded from nearly equal fp32 sums may sit one bf16 step apart, up to
    2^-7 of the largest value, while both keep the plain version's distance
    from the exact result; a wrong kernel moves away from it."""
    if row["max_abs_err"] <= row["tol"]:
        return True
    unit = max(row["scale"], 1e-30)
    return bool(row["kernel_vs_f64"] <= row["plain_vs_f64"] + row["tol"] / unit)


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


def float64_net(net: torch.nn.Module) -> torch.nn.Module:
    """A float64 copy of net with every compute dtype cleared, so that a
    bf16 net's convs and filter head run in float64 too: the gauge's
    evaluation of the same function without rounding."""
    m = copy.deepcopy(net).double()
    for mod in m.modules():
        if getattr(mod, "compute_dtype", None) is not None:
            mod.compute_dtype = None
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = None
    return m


@contextlib.contextmanager
def f64_context(model, batch, swap, on: bool):
    """(model, batch) as they are, or (`on`) a float64 copy of both with
    the plain op of `swap` in place of the kernels' (restored after)."""
    if not on:
        yield model, batch
        return
    module, attr, plain_fn = swap
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain_fn)
    try:
        yield (types.SimpleNamespace(netG=float64_net(model.netG)),
               {k: v.double() for k, v in batch.items()})
    finally:
        setattr(module, attr, kernel_fn)


def plain_dcn(x, offset, mask, weight, bias=None, deformable_groups=1):
    """The plain DCN as the port's CPU path runs it: bf16 columns and
    weights for a bf16 x, float64 for a float64 x."""
    return deform_conv2d_ref(x, offset, mask, weight, bias, deformable_groups=deformable_groups,
                             compute_dtype=x.dtype)


def term_vs_plain(model, batch, alpha: float, swap, gauge: bool = False) -> dict:
    """The second-order part of the meta gradient (second minus first
    order) at `alpha`, with the kernels and with the plain op (`swap` =
    (module, attribute, plain function)): its share of the gradient, the
    relative norm of their difference, their cosine. With `gauge`, also the
    plain op's term on a float64 copy of the net and batch, and each fp32
    term's distance to it (`plain_vs_f64`, `kernel_vs_f64`), read beside
    the float64 term's share and the first-order gradients' distance
    (reported, not held); and the plain op's fp32 term on the batch moved
    by about one ulp (each value times 1 + JITTER N(0, 1), drawn from a
    fixed seed), its distance from the same float64 term
    (`plain_jitter_vs_f64`): a second fp32 draw of the plain op."""
    g1, g2 = meta_gradient(model, batch, alpha, True), meta_gradient(model, batch, alpha, False)
    module, attr, plain_fn = swap
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain_fn)
    try:
        p1, p2 = (meta_gradient(model, batch, alpha, True),
                  meta_gradient(model, batch, alpha, False))
        if gauge:
            gen = torch.Generator(device=p1.device).manual_seed(SEED)
            moved = {k: v * (1 + JITTER * torch.randn(v.shape, generator=gen, device=v.device,
                                                      dtype=v.dtype))
                     for k, v in batch.items()}
            d_jitter = (meta_gradient(model, moved, alpha, False)
                        - meta_gradient(model, moved, alpha, True))
            m64 = types.SimpleNamespace(netG=float64_net(model.netG))
            b64 = {k: v.double() for k, v in batch.items()}
            g64 = meta_gradient(m64, b64, alpha, False)
            d64 = g64 - meta_gradient(m64, b64, alpha, True)
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
                   plain_jitter_vs_f64=float((d_jitter.double() - d64).norm() / d64.norm()),
                   kernel_vs_f64=float((d_kernel.double() - d64).norm() / d64.norm()),
                   share_f64=float(d64.norm() / g64.norm()),
                   first_rel_diff=float((g1 - p1).norm() / p1.norm()))
    return out


def plain_distance(reading: dict) -> float:
    """The plain op's fp32 distance from the float64 term: the larger of
    its two draws (term_vs_plain with gauge), or its one draw where a
    reading has no second."""
    return max(reading["plain_vs_f64"], reading.get("plain_jitter_vs_f64", 0.0))


def gauge_verdict(readings: list, floor: float = GAUGE_FLOOR) -> tuple:
    """(the first well-conditioned try or None, the failures) of gauged
    term readings (term_vs_plain with gauge): on every try the kernels'
    term within GAUGE_FACTOR x the plain op's distance from float64
    (plain_distance: the larger of its two fp32 draws) plus `floor`
    (GAUGE_FLOOR for fp32 terms); on a try where both plain draws lie
    within GAUGE of float64 the kernels within 1e-2 of the plain term. A
    try where the fp32 draws are not all near float64 says nothing of the
    kernels against plain and fails only on the kernels' own distance."""
    bad = []
    for i, r in enumerate(readings, 1):
        plain = plain_distance(r)
        limit = GAUGE_FACTOR * plain + floor
        if not r["kernel_vs_f64"] <= limit:  # a NaN fails too
            bad.append(f"try {i}: the kernels' term is {r['kernel_vs_f64']:.3e} from float64, "
                       f"more than {GAUGE_FACTOR} x the plain term's {plain:.3e} + {floor}")
        if plain <= GAUGE and not r["rel_diff"] <= 1e-2:
            bad.append(f"try {i}: the plain term is within {GAUGE} of float64 and the "
                       f"kernels' differs from it by {r['rel_diff']:.3e} > 1e-2")
    held = next((r for r in readings if plain_distance(r) <= GAUGE), None)
    return held, bad


def second_order_term(tag: str, model, batch, gen: torch.Generator, swap, redraw=None,
                      std: float = 0.0, tries: int = 1, share: float = TERM_SHARE,
                      alphas=ALPHAS, floor: float = GAUGE_FLOOR, by_f64: bool = False) -> dict:
    """The check of the second-order term as a whole, kernels against the
    plain op (`swap`; relative norm <= 1e-2), at the first alpha of `alphas`
    whose term is >= `share` of the meta gradient (with `by_f64`, of the
    plain op's meta gradient on a float64 copy: a bf16 term's own share is
    inflated by its rounding, so it may pick an alpha whose term is mostly
    that rounding). With `redraw` (a
    predicate on parameter names) it runs with those parameters redrawn
    N(0, std) from the seed: a trained-from-zero DCN offset conv or a
    near-zero SpyNet flow puts the bilinear samples on the pixel grid,
    where the derivative jumps and 1e-7 differences between two fp32 paths
    take different sides of the kink (read there too, and reported).

    With `tries` > 1 each try is gauged (term_vs_plain's float64 term) and
    held by gauge_verdict: the kernels' distance from float64 on every try,
    and kernels against plain on a well-conditioned try (its fp32 plain
    term within GAUGE of the float64 one). The tries stop at the first
    well-conditioned one; the next try redraws (or, without `redraw`, takes
    the next windows of the batch). Where fp32 rounding alone decides which
    side of a kink samples take, the fp32 term is ill-conditioned: on TOF's
    meta batch, with some SpyNet biases, the kernels' and the plain warp's
    fp32 terms lay equally far from the float64 one, and two runs of the
    same comparison disagreed by orders of magnitude, a reading that says
    nothing of the kernels; if every try is so, the kernels-vs-plain check
    is reported as not held, and only the kernels' distance can fail. The
    model's weights are restored after."""
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
        with f64_context(model, sub, swap, by_f64) as (m, b):
            for a in (1e-5,) + tuple(alphas):
                g1, g2 = meta_gradient(m, b, a, True), meta_gradient(m, b, a, False)
                ratios[a] = float((g2 - g1).norm() / g2.norm())
                if a > 1e-5 and ratios[a] >= share and math.isfinite(ratios[a]):
                    alpha = a
                    break
        check(alpha is not None,
              f"{tag}: no alpha gives a second-order term >= {share}: {ratios}")
        reading = term_vs_plain(model, sub, alpha, swap, gauge=tries > 1)
        reading.update(ratios=ratios, windows=next(iter(sub.values())).shape[0])
        readings.append(reading)
        if tries == 1 or plain_distance(reading) <= GAUGE:
            held = reading
            break
    bad = gauge_verdict(readings, floor)[1] if tries > 1 else []
    with torch.no_grad():
        for n, p in redrawn.items():
            p.copy_(own[n])
    last = held or readings[-1]
    on_grid = term_vs_plain(model, sub, last["alpha"], swap) if redrawn else last
    what = f"{len(redrawn)} tensors redrawn N(0, {std})" if redrawn else "its own weights"
    gauges = [f"{r.get('plain_vs_f64', math.nan):.2e} / "
              f"{r.get('plain_jitter_vs_f64', math.nan):.2e}" for r in readings]
    kernels = [f"{r.get('kernel_vs_f64', math.nan):.2e}" for r in readings]
    each = [f"alpha {r['alpha']} (term {r['share']:.2e} of the gradient, float64's "
            f"{r.get('share_f64', math.nan):.2e}; kernels vs plain {r['rel_diff']:.2e}, "
            f"gradients {r['grad_rel_diff']:.2e}, first order "
            f"{r.get('first_rel_diff', math.nan):.2e})" for r in readings]
    gauged = (f"; {len(readings)} tries, fp32 vs float64: plain / plain on the batch moved "
              f"by an ulp {gauges} (gauge {GAUGE}), "
              f"kernels {kernels} (limit {GAUGE_FACTOR} x plain + {floor}); tries at "
              f"{each}") if tries > 1 else ""
    own_text = (f"; with the trained weights (samples on the grid's kinks): term "
                f"{on_grid['share']:.3e} of the gradient, |diff|/|term| "
                f"{on_grid['rel_diff']:.3e}, cosine {on_grid['cosine']:.6f}") if redrawn else ""
    held_text = "" if held else (" (no well-conditioned try: kernels vs plain reported, "
                                 "not held)")
    print(f"[{tag}] second-order term (meta gradient second - first order), {what}, "
          f"{last['windows']} window(s): |term|/|grad| by alpha {last['ratios']}; at alpha "
          f"{last['alpha']}: kernels vs plain {swap[1]} |diff|/|term| {last['rel_diff']:.3e} "
          f"(tol 1e-2){held_text}, cosine {last['cosine']:.6f}, whole gradient |diff|/|grad| "
          f"{last['grad_rel_diff']:.3e}{gauged}{own_text}")
    check(not bad, f"{tag}: {bad}")
    if tries == 1:
        check(held["rel_diff"] <= 1e-2,
              f"{tag}: the second-order term differs from the plain op's by {held['rel_diff']}")
    return dict(alpha=last["alpha"], ratios=last["ratios"], off_grid=held, on_grid=on_grid,
                tries=readings, held=held is not None)


def tangent_bound(name, shape, gd, dtype=torch.float32):
    """(bound_ms, bound_by, bytes, flops) of one K8-K10 call: each input
    read once, each output written once, in `dtype`; operations = the
    2*B*HW*C*Cout*9 product (gc for K10) at the dtype's peak."""
    b, c, h, w = shape
    px, e = b * h * w, torch.finfo(dtype).bits // 8
    x, off, msk, wgt, go = px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e, c * c * 9 * e, \
        px * c * e
    nbytes = x + 2 * off + msk + {"dcn_fwd_tangent": wgt + px * c * e,
                                  "dcn_bwd_weight_tangent": go + wgt,
                                  "dcn_bwd_data_tangent": wgt + go + x + off + msk}[name]
    flops = 2 * px * c * c * 9
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


# Graph replays of the K8-K10 wrappers (wrapper_times' rtol): K8 and K10's
# offset / mask gradients bitwise; K9 and K10's grad x sum with fp32 atomics,
# within 1e-5 of the largest value, in bf16 then rounded once (2^-7).
TANGENT_RTOL_BF16 = {"dcn_fwd_tangent": 0.0, "dcn_bwd_weight_tangent": 2.0 ** -7,
                     "dcn_bwd_data_tangent": (2.0 ** -7, 0.0, 0.0)}


def tangent_rows(keep: dict, smi: str) -> list:
    """Each kept K8-K10 call ((name, shape) -> its arguments) checked
    against its plain version and timed (wrapper_times, the plain version,
    the bound in the call's dtype), largest shape first."""
    rows = []
    for name, shape in sorted(keep, key=lambda k: (TANGENT_KERNELS.index(k[0]), -k[1][2])):
        args = keep[(name, shape)]
        gd, dtype = args[-1], args[0].dtype
        fn, plain = getattr(dcn, name), PLAIN_DCN_CALLS[name]
        bound_ms, bound_by, nbytes, flops = tangent_bound(name, shape, gd, dtype)
        out = fn(*args)
        got = [out] if torch.is_tensor(out) else [t for t in out if t is not None]
        want = plain(*args)
        err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
        rtol = (TANGENT_RTOL if dtype == torch.float32 else TANGENT_RTOL_BF16)[name]
        t = wrapper_times(lambda: fn(*args), bound_ms, rtol=rtol)
        plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
        label = dcn_label("meta", shape)
        row = dict(name=name, label=label, dims=list(shape), gd=gd, dtype=str(dtype)[6:],
                   max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   flops=flops, plain_ms=plain_ms, library_ms=None, **t)
        rows.append(row)
        print(f"[timing] {name:22s} {label} Gd={gd} {row['dtype']} max|err| {err:.3e}  "
              f"{times_text(row)}  plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms "
              f"({bound_by})  roofline {row['roofline']:.1%} (kernel "
              f"{row['kernel_roofline']:.1%})  [{smi}]")
    return rows


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

    # Each K8-K10 call size of the meta update: the inner step's pyramid
    # levels, 40 SLR frames of 16x16 (L1 and the cascade), 8x8 and 4x4.
    rows = tangent_rows(keep, smi)
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
    out["est_5f"] = est  # 10c's 5-frame MFDN, phase 14's network_E
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


def meta2_opt(tag: str, gt: str, est: str, root: str, resume: str = None, dtype: str = None,
              niter: int = META_NITER, save=META_SAVE) -> dict:
    """train_DynaVSR_TOF_Vimeo90K.yml / train_DynaVSR_DUF_Vimeo90K.yml as
    cli/train.py derives them, from random weights (the configs'
    checkpoints are not in the repo) with network_E from `est`; `dtype`
    sets network_G's."""
    from dynavsr_tpu_torch.config.options import derive

    run = META2_RUNS[tag]
    opt = {
        "name": run["name"] + (f"_{dtype}" if dtype else ""), "model": "video_meta",
        "scale": SCALE,
        "datasets": {"train": {"name": "Vimeo90K_meta", "mode": "meta", "dataroot_GT": gt,
                               "N_frames": VIMEO_T, "GT_size": 256, "use_shuffle": True,
                               "n_workers": 3, "batch_size": run["batch"]}},
        "network_G": {**run["net"], **({"dtype": dtype} if dtype else {})},
        "network_E": {"which_model_G": "MFDN", "nf": 64},
        "path": {"pretrain_model_G": None, "strict_load": True, "resume_state": resume,
                 "pretrain_model_E": est},
        "train": {"lr_G": 1e-5, "lr_scheme": "constant", "beta1": 0.9, "beta2": 0.99,
                  "niter": niter, "maml_lr_alpha": 1e-5, "maml_adapt_iter": 1,
                  "first_order": False, "pixel_criterion": "cb", "pixel_weight": 1.0,
                  "val_freq": 5e3, "manual_seed": 0},
        "logger": {"print_freq": 1, "save_checkpoint_freq": save or 5e3},
    }
    return derive(opt, is_train=True, root=root)


def _plain_vjp(fn, x, second, grad_out, need_x):
    """The plain op's (grad x, unless not `need_x`; grad of its second
    input) on the same inputs, in fp32 (float64 for a float64 x: the
    float64 gauge)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    with torch.enable_grad():
        xr = x.detach().to(dt).requires_grad_(need_x)
        sr = second.detach().to(dt).requires_grad_()
        grads = torch.autograd.grad(fn(xr, sr), [xr, sr] if need_x else [sr], grad_out.to(dt))
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
        with meta_charbonnier(TERM_CB_EPS):
            out[tag]["term"] = second_order_term(f"meta2 11c {arch}", model, term_batch, gen,
                                                 run["swap"], redraw, SPY_BIAS_STD, tries=tries)
        # The configs' loss at the same alpha and the model's own weights: reported.
        configs = term_vs_plain(model, term_batch, out[tag]["term"]["alpha"], run["swap"],
                                gauge=True)
        print(f"[meta2] 11c {arch} with the configs' Charbonnier (eps 1e-12), its own weights, "
              f"alpha {out[tag]['term']['alpha']}: term {configs['share']:.3e} of the gradient "
              f"(float64 {configs['share_f64']:.3e}), from float64: kernels "
              f"{configs['kernel_vs_f64']:.3e}, plain {configs['plain_vs_f64']:.3e} / "
              f"{configs['plain_jitter_vs_f64']:.3e} (reported)")
        out[tag]["term_configs_loss"] = configs
        if arch == "TOF":
            out[tag]["kink_probe"] = kink_probe(model, batch, gen)
        out[tag]["seconds"] = time.perf_counter() - t_run
        del model
        torch.cuda.empty_cache()
    return out, rows, launches

# --------------------------------------------------------------- phase 12
# Tiled inference (eval/tiled.py), JAX's schedule: every tile of a call's
# windows in one batch. 12a: test_DynaVSR_Vid4.yml's EDVR-M x4 + MFDN through
# run_clip on a 7-frame smooth clip at LR 540x960 (-> 2160x3840), whole
# frame and tiled 256 / overlap 32 (3 x 5 = 15 tiles a frame). 12b: DUF-16L
# at 144x176, tile 64 / overlap 12, at least its receptive-field radius: the
# tiles are exact. 12c: cli/test.py's path (create_model -> make_infer_fn)
# with eval.tile 128 / overlap 32 on 8a's clip.
BIG_T, BIG_H, BIG_W = 7, 540, 960
BIG_TILE, BIG_OVERLAP = 256, 32
DUF_TILE, DUF_OVERLAP = 64, 12
EVAL_TILE, EVAL_OVERLAP = 128, 32


def k1_vs_plain(calls: dict, what: str, chunk: int = 15) -> list:
    """Every kind of K1 call recorded by record_dcn_calls on a forward
    (fp32, no gradient), held against the plain DCN at phase 3's fp32
    tolerance (1e-4 of the plain result's largest value), both timed.
    Frames are independent, so the plain version runs `chunk` frames at a
    time: its columns for a 75-frame 256^2 call would be an 11 GB
    temporary."""
    rows = []
    for label, call in sorted(calls.items()):
        x, offset, mask, weight, bias = call["args"]
        gd = call["gd"]

        def plain():
            return torch.cat([deform_conv2d_ref(x[s: s + chunk], offset[s: s + chunk],
                                                mask[s: s + chunk], weight, bias,
                                                deformable_groups=gd)
                              for s in range(0, x.shape[0], chunk)])

        with torch.no_grad():
            out, ref = dcn.dcn_fwd(x, offset, mask, weight, bias, gd), plain()
            ms = cuda_ms(lambda: dcn.dcn_fwd(x, offset, mask, weight, bias, gd), reps=5)
            plain_ms = cuda_ms(plain, reps=1, warmup=0)
        err, tol = float((out - ref).abs().max()), 1e-4 * float(ref.abs().max())
        bound_ms, bound_by, _, _ = dcn_bound("dcn_fwd", tuple(x.shape), gd, x.dtype)
        print(f"[tiles] {what}: K1 on {tuple(x.shape)} Gd {gd} ({call['count']} a forward) vs "
              f"plain DCN: max|err| {err:.3e} (tol {tol:.3e}); {ms:.3f} ms a call, plain "
              f"{plain_ms:.3f} ms (bound {bound_ms:.3f} ms, {bound_by})")
        check(label.startswith("infer"), f"{what}: {label} is not a forward call")
        check(err <= tol, f"{what}: K1 {label} differs from the plain DCN by {err} > {tol}")
        rows.append(dict(name="dcn_fwd", label=label, dims=list(x.shape), count=call["count"],
                         max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by))
        del out, ref
    return rows


# (recorder, against) of each op that a tiled forward or a stream runs:
# recorder(run) -> that op's calls during run(), by kind (record_dcn_calls,
# record_calls); against(label, rec) -> the rows of its kernels held against
# the plain op at phase 3's tolerances, and timed.
DCN_PATH = (record_dcn_calls,
            lambda label, rec: against_plain(label, *rec["args"], rec.get("cot"), rec["gd"],
                                             timed=True))
WARP_PATH = (lambda run: record_calls(run, tof_module, "warp_nchw"),
             lambda label, rec: warp_against_plain(label, *rec["args"], rec.get("cot"),
                                                   need_x=False, timed=True))
DUF_PATH = (lambda run: record_calls(run, duf_module, "dynamic_upsampling_filter"),
            lambda label, rec: duf_against_plain(label, *rec["args"], rec.get("cot"),
                                                 need_x=False, timed=True))


def calls_vs_plain(what: str, calls: dict, against) -> list:
    """Every kind of call in `calls` held against the plain op by
    `against(label, rec)` (raises if one disagrees) and timed; each row
    tagged with `what` and the kind's count in the recorded run."""
    rows = []
    for label, rec in sorted(calls.items()):
        had_bwd = rec["bwd"] > 0 if "bwd" in rec else label.startswith("adapt")
        check(not had_bwd or rec.get("cot") is not None, f"{what} {label}: no gradient recorded")
        for row in against(label, rec):
            row.update(run=what, count=rec["count"])
            rows.append(row)
    return rows


def frame_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of b against a over [0, 1] frames (both clipped), in dB."""
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2, dtype=np.float64))
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def phase_tiles(smi: str, gen: torch.Generator, duf: dict, reds: dict) -> dict:
    out = {}
    # 12a: EDVR-M at 540x960 LR, whole frame vs tiles.
    lq, _ = synthetic_clip(gen, BIG_T, BIG_H, BIG_W)
    vsr = define_G({"network_G": EDVR_M})
    init_weights(vsr, gen)
    est = build_estimator({"nf": MFDN_NF}, SCALE, EDVR_M["nframes"])
    init_weights(est, gen)
    nf, tile = EDVR_M["nframes"], (BIG_TILE, BIG_TILE)
    whole_apply = make_model_apply("EDVR", SCALE)
    tiled_apply = make_tiled_apply(whole_apply, tile, BIG_OVERLAP, SCALE)
    all_win = all_windows(BIG_T, nf, "reflection")
    srs = {}
    for label, chunk, tiled in (("whole, chunk 1", 1, None), ("tiled, chunk 1", 1, tile),
                                ("tiled, chunk 2", 2, tile)):
        cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=chunk)
        reset_all_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sr, res = run_clip(vsr, est, lq, None, cfg, seq=False, n_frames=nf, padding="reflection",
                           n_adapt=BIG_T, tile=tiled, tile_overlap=BIG_OVERLAP)
        secs = time.perf_counter() - t0  # run_clip returns host arrays: synchronised
        peak, counts = torch.cuda.max_memory_allocated(), all_counts()
        losses = res["adapt_losses"]
        check(sr.shape == (BIG_T, BIG_H * SCALE, BIG_W * SCALE, 3) and bool(np.isfinite(sr).all()),
              f"12a {label}: SR")
        check(len(losses) == 5 and all(math.isfinite(v) for v in losses), f"12a {label}: {losses}")
        # K1: 5 adaptation steps x 4 DCNs, then 4 a forward of `chunk` windows.
        expect = {"dcn_fwd": 4 * (5 + -(-BIG_T // chunk)), "dcn_bwd_data": 20,
                  "dcn_bwd_weight": 20}
        check_only(counts, expect, f"12a {label}")
        srs[label] = sr
        # run_clip's peak is the estimator's (MFDN on 7 full-size windows):
        # the inference forward's own, one chunk of windows, is measured
        # apart, above what is held, with its time (the card synchronised).
        windows = torch.as_tensor(lq[all_win[:chunk]], device="cuda")
        fwd = tiled_apply if tiled else whole_apply
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fwd(vsr, windows)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t0
        fwd_peak = torch.cuda.max_memory_allocated() - held
        del windows
        out[f"12a {label}"] = dict(secs=secs, fps=BIG_T / secs, peak=peak, counts=counts,
                                   losses=losses, forward_s_per_frame=fwd_s / chunk,
                                   forward_peak=fwd_peak)
        print(f"[tiles] 12a EDVR-M x4 LR {BIG_H}x{BIG_W} -> {BIG_H * SCALE}x{BIG_W * SCALE}, "
              f"{label:15s} {secs:.3f} s/clip  {BIG_T / secs:.3f} frames/s  peak "
              f"{peak / 2**30:.2f} GiB; one forward of {chunk} window(s) alone: "
              f"{fwd_s / chunk:.3f} s a frame, peak {fwd_peak / 2**30:.2f} GiB above the "
              f"{held / 2**30:.2f} held  launches {({k: v for k, v in counts.items() if v})}  "
              f"[{smi}]")
    whole = srs["whole, chunk 1"]
    for label in ("tiled, chunk 1", "tiled, chunk 2"):
        d = float(np.abs(srs[label] - whole).max())
        psnr = frame_psnr(whole, srs[label])
        check(math.isfinite(d), f"12a {label}: |tiled - whole| {d}")
        out[f"12a {label}"].update(max_abs_vs_whole=d, psnr_vs_whole=psnr)
        print(f"[tiles] 12a {label}: max |tiled - whole| {d:.3e}, PSNR vs whole {psnr:.2f} dB "
              "(EDVR's offsets are unbounded: not tile-exact; reported)")
    d12 = float(np.abs(srs["tiled, chunk 1"] - srs["tiled, chunk 2"]).max())
    print(f"[tiles] 12a max |chunk 1 - chunk 2| tiled: {d12:.3e}")
    del srs, whole
    win = torch.as_tensor(lq[all_win[:1]], device="cuda")
    n_tiles = len(tile_plan(BIG_H, BIG_TILE, BIG_OVERLAP)[0]) * len(
        tile_plan(BIG_W, BIG_TILE, BIG_OVERLAP)[0])
    with torch.no_grad():
        calls = record_dcn_calls(lambda: tiled_apply(vsr, win))
    check(dcn_label("infer", (n_tiles * nf, 64, BIG_TILE, BIG_TILE)) in calls,
          f"12a: no K1 call on the tile batch: {sorted(calls)}")
    out["12a K1 vs plain"] = k1_vs_plain(calls, "12a tile batch")
    del calls, vsr, est, win
    torch.cuda.empty_cache()

    # 12b: DUF-16L, tiles exact.
    apply = make_model_apply("DUF", SCALE)
    windows = torch.as_tensor(duf["lq"][all_windows(CLIP_T, DUF_FRAMES, "new_info")[:INFER_CHUNK]],
                              device="cuda")
    tiled_duf = make_tiled_apply(apply, DUF_TILE, DUF_OVERLAP, SCALE)
    with torch.no_grad():
        whole = apply(duf["net"], windows)
        reset_all_counts()
        tiled = tiled_duf(duf["net"], windows)
        counts = all_counts()
        calls = record_calls(lambda: tiled_duf(duf["net"], windows), duf_module,
                             "dynamic_upsampling_filter")
    d = float((tiled - whole).abs().max())
    out["12b"] = dict(max_abs_vs_whole=d, counts=counts,
                      calls=calls_vs_plain("12b tile batch", calls, DUF_PATH[1]))
    print(f"[tiles] 12b DUF-16L {tuple(windows.shape)} tile {DUF_TILE} overlap {DUF_OVERLAP}: "
          f"max |tiled - whole| {d:.3e} (limit 1e-4)  launches "
          f"{({k: v for k, v in counts.items() if v})}")
    check(d <= 1e-4, f"12b: tiled DUF differs from the whole frame by {d}")
    check_only(counts, {"duf_fwd": 1}, "12b")
    del whole, tiled, windows

    # 12c: plain eval tiled, through create_model's forward, on 8a's clip.
    opt = {"scale": SCALE, "network_G": EDVR_REDS4, "path": {},
           "eval": {"infer_chunk": EVAL_CHUNK, "tile": EVAL_TILE, "tile_overlap": EVAL_OVERLAP}}
    model = create_model(opt)
    model.netG.load_state_dict(reds["state"])
    check(model.make_seq_infer_fn() is None, "12c: a tiled sequence mode")
    serve_set = MemoryTestSet({"000": (reds["lq"], None)}, EDVR_REDS4["nframes"], "new_info")
    outs, secs = [], []
    with torch.no_grad():  # warm-up at the tile shapes, each kind of K1 call recorded
        calls = record_dcn_calls(lambda: evaluate_dataset(
            model.make_infer_fn(), serve_set, n_frames=5, padding="new_info", chunk=EVAL_CHUNK))
    reset_all_counts()
    evaluate_dataset(recorded(model.make_infer_fn(), outs, secs), serve_set, n_frames=5,
                     padding="new_info", chunk=EVAL_CHUNK)
    counts, sr = all_counts(), np.concatenate(outs)
    check_only(counts, {"dcn_fwd": -(-REDS_T // EVAL_CHUNK) * 4}, "12c")
    d = float(np.abs(sr - reds["sr"]).max())
    check(sr.shape == reds["sr"].shape and math.isfinite(d), f"12c: |tiled - 8a| {d}")
    out["12c"] = dict(max_abs_vs_8a=d, psnr_vs_8a=frame_psnr(reds["sr"], sr),
                      infer_fps=REDS_T / sum(secs), counts=counts,
                      calls=k1_vs_plain(calls, "12c tile batch"))
    print(f"[tiles] 12c create_model eval.tile {EVAL_TILE} overlap {EVAL_OVERLAP} on 8a's clip: "
          f"max |tiled - 8a| {d:.3e}, PSNR vs 8a {out['12c']['psnr_vs_8a']:.2f} dB (reported), "
          f"{REDS_T / sum(secs):.3f} frames/s in the forwards  launches "
          f"{({k: v for k, v in counts.items() if v})}; make_seq_infer_fn None  [{smi}]")
    del model
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- phase 13
# Online serving (eval/streaming.py) of phase 4-6's nets on their clips:
# 13a StreamingSR EDVR-M + MFDN adapter (K 8, 5 Adam steps, lr 1e-6) fp32
# and bf16; 13b WindowStreamSR TOF / DUF-16L with the train_ema adapter;
# 13c MultiStreamSR B = 4 EDVR-M fp32, shared and adapted in G = 1 / 2 / 4
# groups, on four clips from other seeds.
STREAM_B, STREAM_GROUPS = 4, (1, 2, 4)


def drive(stream, frames, profile_dir=None, profile_at=None, record=None) -> tuple:
    """Push `frames` through `stream`, the card synchronised before and
    after each push, then flush. Returns the emitted SR on the host (in
    frame order), one row per push (host seconds until push() returned,
    seconds until the card finished, frames emitted, launches), for push
    `profile_at`, run under utils/observability.profile_trace into
    profile_dir and left out of the rows, the device's busy / idle share,
    and, with record = (recorder, pushes), an op's calls during each of
    those pushes, by push and kind (a pass that records is not a measured
    one: its rows time the recording too)."""
    got, rows, prof_row, calls = [], [], None, {}
    for i, f in enumerate(frames):
        before = all_counts()
        torch.cuda.synchronize()
        if i == profile_at:
            with profile_trace(profile_dir) as prof:
                t0 = time.perf_counter()
                emitted = stream.push(f)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof_row = device_share(prof, wall * 1e6)
            print(f"[stream]   push {i} under profile_trace: {prof_row}")
        else:
            t0 = time.perf_counter()
            if record and i in record[1]:
                box = []
                calls[i] = record[0](lambda: box.append(stream.push(f)))
                emitted = box[0]
            else:
                emitted = stream.push(f)
            t_host = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = {k: v - before[k] for k, v in all_counts().items() if v - before[k]}
            rows.append((t_host, time.perf_counter() - t0, len(emitted), counts))
        got.extend(emitted)
    got.extend(stream.flush())
    check([i for i, _ in got] == list(range(len(frames))),
          f"the stream emitted {[i for i, _ in got]}")
    dim = 0 if got[0][1].dim() == 3 else 1  # MultiStreamSR: (B, T, ...)
    return torch.stack([s for _, s in got], dim=dim).cpu().numpy(), rows, prof_row, calls


def stream_stats(rows, warm: int) -> dict:
    """The warm-up push (index `warm`), and medians over the later pushes
    that emitted one frame (a MultiStreamSR push: one frame a stream)."""
    after = [r for r in rows[warm + 1:] if r[2] == 1]
    check(len(after) >= 3, f"only {len(after)} steady pushes")
    return dict(warmup_s=rows[warm][1], warmup_launches=rows[warm][3],
                steady_ms=float(np.median([r[1] for r in after])) * 1e3,
                host_us=float(np.median([r[0] for r in after])) * 1e6,
                steady_launches=after[0][3], steady_pushes=len(after),
                every_steady_push_same=all(r[3] == after[0][3] for r in after))


def device_share(prof, wall_us: float) -> dict:
    """The device's busy / idle share of `wall_us` and its top operations,
    from a profiler's device events."""
    events, by_name = device_events(prof), {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not events:
        return dict(wall_ms=wall_us / 1e3, note="no device events recorded (not measured)")
    busy = busy_us(events)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    kernels = {k: round(sum(us for n, us in by_name.items()
                            if any(p in n for p in (f"{k}_kernel", *PROLOGUES.get(k, ()))))
                        / 1e3, 4)
               for k in (*DCN_KERNELS, *WARP_KERNELS, *DUF_KERNELS)}
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3, idle_share=1 - busy / wall_us,
                kernel_ms={k: v for k, v in kernels.items() if v},
                top=[(n[:80], round(us / 1e3, 4)) for n, us in top])


def windows_sr(net, frames: np.ndarray, n: int, padding: str) -> np.ndarray:
    """The offline window-batched forward over every window of a clip,
    INFER_CHUNK windows a call."""
    win = torch.as_tensor(frames[all_windows(len(frames), n, padding)], device="cuda")
    apply = make_model_apply(net.arch, SCALE)
    with torch.no_grad():
        return chunked_apply(lambda w: apply(net, w), win, INFER_CHUNK).cpu().numpy()


def pushes_vs_plain(what: str, by_push: dict, warm: int, against) -> dict:
    """The calls that drive recorded in the warm-up push (`warm`) and in a
    steady push (`warm` + 2), each kind held against the plain op and
    timed; the steady push's time in each kernel and in its plain version,
    a kind's timed call times its count in that push."""
    check(sorted(by_push) == [warm, warm + 2], f"{what}: recorded pushes {sorted(by_push)}")
    out = dict(warmup=calls_vs_plain(f"{what} warm-up push", by_push[warm], against),
               steady=calls_vs_plain(f"{what} steady push", by_push[warm + 2], against))
    per_push = {}
    for r in out["steady"]:
        t = per_push.setdefault(r["name"], dict(launches=0, ms=0.0, plain_ms=0.0))
        t["launches"] += r["count"]
        t["ms"] += r["ms"] * r["count"]
        t["plain_ms"] += r["plain_ms"] * r["count"]
    out["steady_push"] = per_push
    print(f"[stream] {what}: every kind of kernel call of the warm-up push and of a steady "
          f"push agrees with the plain op; a steady push in the kernels (timed calls x count) "
          f"{ {k: {kk: round(vv, 4) for kk, vv in v.items()} for k, v in per_push.items()} }")
    return out


def phase_stream(smi: str, gen: torch.Generator, lq: np.ndarray, duf_lq: np.ndarray,
                 edvr: dict, tof: dict, duf: dict, trace_dir: str) -> dict:
    """Each streamer twice: a pass that records the op's calls of the
    warm-up push and of a steady push (held against the plain op), then
    the measured pass. A fp32 stream must equal its reference within
    1e-4, and be nearer to it than the unadapted net's output is (the
    adaptation's move, reported beside)."""
    out, nf = {}, EDVR_M["nframes"]
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    edvr_adapter = make_streaming_adapter(cfg, edvr["est"],
                                          apply_fn=make_model_apply("EDVR", SCALE))

    def served(what, make, frames, path, ref, unadapted, warm=None, profile_after=None):
        """make() -> a stream; the recording pass, then the measured one,
        whose SR is held against `ref` (fp32: within 1e-4, and nearer than
        `unadapted`)."""
        for measured in (False, True):
            stream = make()
            w = stream._warm_need - 1 if warm is None else warm
            torch.cuda.reset_peak_memory_stats()
            sr, rows, prof, by_push = drive(
                stream, frames, trace_dir,
                w + profile_after if measured and profile_after else None,
                record=None if measured else (path[0], (w, w + 2)))
            if not measured:
                calls = pushes_vs_plain(what, by_push, w, path[1])
        stats = stream_stats(rows, w)
        d = float(np.abs(sr - ref).max())
        move = float(np.abs(ref - unadapted).max())
        stats.update(peak=torch.cuda.max_memory_allocated(), max_abs_vs_reference=d,
                     adaptation_move=move, profile=prof, calls=calls)
        return stats, d, move

    # 13a: one EDVR stream, fp32 and bf16, against phase 4's window-batched
    # run_clip; the recording pass also warms up (cuDNN plans at B = 1).
    for dt_name, net in (("fp32", edvr["vsr32"]), ("bf16", edvr["vsr16"])):
        stats, d, move = served(
            f"13a {dt_name}", lambda: StreamingSR(net, n_frames=nf, adapter=edvr_adapter,
                                                  adapt_windows=N_WINDOWS),
            lq, DCN_PATH, edvr["sr"][dt_name], windows_sr(net, lq, nf, "reflection"),
            profile_after=3)
        out[f"13a {dt_name}"] = stats
        check(stats["steady_launches"] == {"dcn_fwd": 4} and stats["every_steady_push_same"],
              f"13a {dt_name}: a steady push launched {stats['steady_launches']}")
        wl = stats["warmup_launches"]
        check(wl.get("dcn_bwd_data") == 20 and wl.get("dcn_bwd_weight") == 20,
              f"13a {dt_name}: the warm-up launched {wl}")
        gap = (f"(limit 1e-4)" if dt_name == "fp32"
               else f"(phase 4's bf16 windows vs seq: {edvr['d16']:.3e})")
        print(f"[stream] 13a StreamingSR EDVR-M {dt_name}: warm-up push {stats['warmup_s']:.3f} s "
              f"(K {N_WINDOWS}, launches {wl}), steady {stats['steady_ms']:.3f} ms/frame, host "
              f"{stats['host_us']:.1f} us a push ({stats['steady_pushes']} pushes; launches "
              f"{stats['steady_launches']}), peak {stats['peak'] / 2**30:.2f} GiB; max |stream - "
              f"run_clip| {d:.3e} {gap}; the adaptation moved run_clip by {move:.3e}  [{smi}]")
        if dt_name == "fp32":
            check(d <= 1e-4 and d < move,
                  f"13a: the fp32 stream differs from run_clip by {d} (adaptation's move {move})")

    # 13b: the window streamers on phase 5's and 6's clips, fp32.
    for tag, ctx, frames, n, pad, path in (("TOF", tof, lq, TOF_FRAMES, "reflection", WARP_PATH),
                                           ("DUF", duf, duf_lq, DUF_FRAMES, "new_info", DUF_PATH)):
        adapter = make_streaming_adapter(cfg, ctx["est"], apply_fn=make_model_apply(tag, SCALE),
                                         mutable_apply_fn=make_mutable_model_apply(tag, SCALE))
        stats, d, move = served(
            f"13b {tag}", lambda: WindowStreamSR(ctx["net"], n_frames=n, padding=pad,
                                                 adapter=adapter, adapt_windows=N_WINDOWS),
            frames, path, ctx["sr"], windows_sr(ctx["net"], frames, n, pad), profile_after=2)
        out[f"13b {tag}"] = stats
        fwd = "warp_fwd" if tag == "TOF" else "duf_fwd"
        per_push = (n - 1) * (SPY_LEVELS + 1) if tag == "TOF" else 1
        check(stats["steady_launches"] == {fwd: per_push} and stats["every_steady_push_same"],
              f"13b {tag}: a steady push launched {stats['steady_launches']}")
        print(f"[stream] 13b WindowStreamSR {tag} fp32: warm-up push {stats['warmup_s']:.3f} s "
              f"(launches {stats['warmup_launches']}), steady {stats['steady_ms']:.3f} ms/frame, "
              f"host {stats['host_us']:.1f} us a push (launches {stats['steady_launches']}), peak "
              f"{stats['peak'] / 2**30:.2f} GiB; max |stream - run_clip| {d:.3e} (limit 1e-4); "
              f"the adaptation moved run_clip by {move:.3e}  [{smi}]")
        check(d <= 1e-4 and d < move,
              f"13b {tag}: the stream differs from run_clip by {d} (adaptation's move {move})")

    # 13c: B = 4 EDVR-M streams in lockstep, fp32, on four clips of other
    # seeds: shared, then adapted in G groups, each stream held against its
    # reference construction (the group's pooled first-K windows through the
    # one-stream adapter, then the offline window-batched forward).
    net = edvr["vsr32"]
    clips = np.stack([synthetic_clip(torch.Generator(device="cuda").manual_seed(SEED + 1 + s))[0]
                      for s in range(STREAM_B)])  # (B, T, h, w, 3)
    first_k = [index_generation(j, 1 << 30, nf, "reflection") for j in range(N_WINDOWS)]
    unadapted = np.stack([windows_sr(net, clips[s], nf, "reflection") for s in range(STREAM_B)])
    for groups in (0, *STREAM_GROUPS):
        label = "shared" if groups == 0 else f"G={groups}"
        ref = unadapted.copy()
        per = STREAM_B // (groups or STREAM_B)
        for g0 in range(0, STREAM_B, per) if groups else ():
            pooled = torch.as_tensor(np.concatenate(
                [clips[s][np.asarray(first_k)] for s in range(g0, g0 + per)]), device="cuda")
            ref_net, _ = edvr_adapter(net, pooled)
            for s in range(g0, g0 + per):
                ref[s] = windows_sr(ref_net, clips[s], nf, "reflection")
        # Shared streams have no warm-up: "warm-up" is their first emitting push.
        stats, worst, move = served(
            f"13c {label}", lambda: MultiStreamSR(
                net, n_streams=STREAM_B, n_frames=nf, n_groups=groups or None,
                adapt_windows=N_WINDOWS if groups else 0,
                adapter=make_streaming_adapter(
                    cfg, edvr["est"], apply_fn=make_model_apply("EDVR", SCALE),
                    batched=True) if groups else None),
            clips.transpose(1, 0, 2, 3, 4), DCN_PATH, ref, unadapted,
            warm=None if groups else nf // 2)
        stats.update(ms_per_frame_per_stream=stats["steady_ms"] / STREAM_B)
        out[f"13c {label}"] = stats
        print(f"[stream] 13c MultiStreamSR B={STREAM_B} EDVR-M fp32 {label:6s}: steady "
              f"{stats['steady_ms']:.3f} ms a push = {stats['ms_per_frame_per_stream']:.3f} "
              f"ms/frame/stream, host {stats['host_us']:.1f} us a push (launches "
              f"{stats['steady_launches']}), warm-up push {stats['warmup_s']:.3f} s, peak "
              f"{stats['peak'] / 2**30:.2f} GiB; max |stream - reference| {worst:.3e} (limit "
              f"1e-4); the adaptation moved the reference by {move:.3e}  [{smi}]")
        check(worst <= 1e-4 and (not groups or worst < move),
              f"13c {label}: a stream differs from its reference by {worst} (move {move})")
    return out


# --------------------------------------------------------------- phase 14
# Multi-device (parallel/mesh.py, one process a card) on the one card:
# 14a clip-parallel adaptation (cli/test_dynavsr.run_clips) of phase 4's
# nets at world size 1 over NCCL; 14b the same clips at 2 ranks sharing the
# card, over gloo (NCCL refuses two ranks on one device; gloo takes
# all_reduce and broadcast on CUDA tensors, the only device collectives the
# port uses); 14c one supervised step (9a's config, global batch 32) and 14d
# one second-order meta step (10c's, global batch 8) at 2 ranks, each
# against the one-process step on the same global batch. The 2 ranks of
# 14b-14d are one spawn; each rank writes its readings for this process.
MULTI_CLIPS = {"m1": (16, 144, 176), "m2": (16, 144, 176), "m3": (7, 144, 176),
               "m4": (16, 120, 180), "m5": (12, 120, 180)}  # frames, LR height, width
MULTI_SEED, MULTI_RANKS = 140, 2


def multi_clips() -> dict:
    """name -> (lq, gt): synthetic_clip at each size, one seed a clip."""
    out = {}
    for i, (name, (t, h, w)) in enumerate(MULTI_CLIPS.items()):
        out[name] = synthetic_clip(torch.Generator(device="cuda").manual_seed(MULTI_SEED + i),
                                   t, h, w)
    return out


def multi_launches(world: int, cfg: AdaptConfig) -> dict:
    """K1-K3 launches a rank makes over MULTI_CLIPS clip-parallel: each
    resolution bucket padded to a multiple of the world and shared out;
    a clip adapts in n_steps x 4 DCNs and infers its bucket's padded
    windows (windows: the longest clip's; sequence mode: that rounded up to
    8) in chunks of infer_chunk, 4 DCNs a chunk: both 16 here."""
    buckets: dict = {}
    for t, h, w in MULTI_CLIPS.values():
        buckets.setdefault((h, w), []).append(t)
    k1 = k2 = 0
    for ts in buckets.values():
        clips = -(-len(ts) // world)
        rows = -(-max(ts) // 8) * 8
        k1 += clips * 4 * (cfg.n_steps + -(-rows // cfg.infer_chunk))
        k2 += clips * 4 * cfg.n_steps
    return {"dcn_fwd": k1, "dcn_bwd_data": k2, "dcn_bwd_weight": k2}


def clips_kwargs() -> dict:
    return dict(n_frames=EDVR_M["nframes"], padding="reflection", n_adapt=N_WINDOWS,
                scale=SCALE)


def selected_reference(vsr, est, lq: np.ndarray, cfg: AdaptConfig, seq: bool) -> np.ndarray:
    """The per-clip path (make_adapt_and_infer[_seq]) fed batch_clips'
    choice of adaptation windows: a clip shorter than n_adapt windows
    repeats them to n_adapt, where run_clip takes each once (so does JAX)."""
    from dynavsr_tpu_torch.adapt.adaptation import make_adapt_and_infer, make_adapt_and_infer_seq

    t, h, w = lq.shape[:3]
    n = EDVR_M["nframes"]
    win = all_windows(t, n, "reflection")
    adapt_w = torch.as_tensor(lq[win[np.resize(np.arange(min(t, N_WINDOWS)), N_WINDOWS)]],
                              device="cuda")
    with torch.no_grad():
        slr = est(adapt_w)
    apply = make_model_apply("EDVR", SCALE)
    if seq:
        frames = np.pad(lq, [(0, 0), (0, (-h) % 4), (0, (-w) % 4), (0, 0)], mode="reflect")
        sr, _ = make_adapt_and_infer_seq(cfg, apply)(
            vsr, slr, adapt_w[:, n // 2], torch.as_tensor(frames, device="cuda"),
            torch.as_tensor(win, dtype=torch.long, device="cuda"))
        sr = sr[:, : h * SCALE, : w * SCALE]
    else:
        sr, _ = make_adapt_and_infer(cfg, apply)(vsr, slr, adapt_w[:, n // 2],
                                                 torch.as_tensor(lq[win], device="cuda"))
    return sr.cpu().numpy()


def phase_multi_clips(smi: str, edvr: dict, clips: dict) -> dict:
    """14a: run_clips at world size 1 (a NCCL group of one, made by
    init_dist from the variables torchrun would set), window-batched and
    sequence mode, against run_clip (clips of >= 8 frames) and
    selected_reference (the 7-frame clip), timed against the serial
    run_clip loop, both without GT (scoring, host work, is not timed);
    every kind of K1-K3 call held against the plain DCN."""
    from dynavsr_tpu_torch.cli.test_dynavsr import run_clips
    from dynavsr_tpu_torch.parallel import mesh

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(mesh.free_port()), RANK="0",
                      WORLD_SIZE="1", LOCAL_RANK="0")
    dev = mesh.init_dist("pytorch")
    check(dev.type == "cuda" and torch.distributed.get_backend() == "nccl"
          and mesh.get_world_size() == 1, f"14a: group {torch.distributed.get_backend()} on {dev}")
    vsr, est = edvr["vsr32"], edvr["est"]
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    out, sr_out = {}, {}
    unscored = {c: (lq, None) for c, (lq, _) in clips.items()}
    try:
        for seq in (False, True):
            mode = "seq" if seq else "windows"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = {c: run_clip(vsr, est, lq, None, cfg, seq=seq, **clips_kwargs())[0]
                   for c, (lq, _) in clips.items()}
            serial_s = time.perf_counter() - t0
            short = {c for c, (t, _, _) in MULTI_CLIPS.items() if t < N_WINDOWS}
            for c in short:
                ref[c] = selected_reference(vsr, est, clips[c][0], cfg, seq)
            reset_all_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = run_clips(vsr, est, unscored, cfg, seq=seq, **clips_kwargs())
            secs = time.perf_counter() - t0
            counts = all_counts()
            check_only(counts, multi_launches(1, cfg), f"14a {mode}")
            sr = {c: v[0] for c, v in got.items()}
            diffs = {c: float(np.abs(sr[c] - ref[c]).max()) for c in ref}
            check(set(sr) == set(ref) and all(d <= 1e-4 for d in diffs.values()),
                  f"14a {mode}: SR vs the per-clip reference {diffs} (limit 1e-4)")
            sr_out[mode] = sr
            out[mode] = dict(s=secs, serial_s=serial_s, launches=counts, max_diff=diffs,
                             losses={c: v[1]["adapt_losses"] for c, v in got.items()})
            print(f"[multi] 14a {mode}: {len(clips)} clips clip-parallel at world size 1 in "
                  f"{secs:.3f} s, the serial run_clip loop {serial_s:.3f} s; max |SR - "
                  f"per-clip reference| {max(diffs.values()):.3e} (limit 1e-4; {sorted(short)} "
                  f"against batch_clips' window choice); launches {counts}  [{smi}]")
        calls = record_dcn_calls(lambda: [run_clips(vsr, est, unscored, cfg, seq=s,
                                                    **clips_kwargs()) for s in (False, True)])
        out["calls"] = calls_vs_plain("14a", calls, DCN_PATH[1])
    finally:
        torch.distributed.destroy_process_group()
    return out, sr_out


def one_step(opt: dict, module, check_calls: bool = False) -> dict:
    """cli/train.train for one iteration of `opt`, with the gradient of the
    update, the parameters after it, the launches and (check_calls) every
    K1-K3 / K8-K10 call held against the plain version as it happens."""
    from dynavsr_tpu_torch.cli.train import train

    grads, after = [], []
    orig = module.apply_update  # train/trainer.py's, or train/meta.py's copy

    def update(optimizer, params, *args):
        """orig, logging the gradients it is handed (all-reduced under a
        group) and the parameters it leaves."""
        params = list(params)
        grads.append(torch.cat([p.grad.flatten() for p in params]).detach().clone())
        gnorm = orig(optimizer, params, *args)
        after.append(torch.cat([p.detach().flatten() for p in params]).clone())
        return gnorm

    module.apply_update = update
    reset_all_counts()
    rows, kept = [], {}
    try:
        if check_calls:
            rows, kept = checked_calls(lambda: train(opt, max_iters=1), dcn, PLAIN_DCN_CALLS,
                                       keep=tuple(PLAIN_DCN_CALLS), by_shape=True)
        else:
            train(opt, max_iters=1)
    finally:
        module.apply_update = orig
    check(len(grads) == 1, f"{opt['name']}: {len(grads)} updates")
    return dict(grad=grads[0], after=after[0], launches=all_counts(), calls=rows, kept=kept)


def time_kept(kept: dict) -> list:
    """Each kept K1-K3 / K8-K10 call (the first at each input shape) timed
    with CUDA events, beside its plain version and its bound."""
    rows = []
    for (name, shape), args in sorted(kept.items()):
        kernel = "dcn_fwd" if name == "_fwd" else name
        gd = args[-1]
        bound_ms, bound_by, _, _ = (tangent_bound(kernel, shape, gd) if kernel in TANGENT_KERNELS
                                    else dcn_bound(kernel, shape, gd, torch.float32))
        with torch.no_grad():
            ms = cuda_ms(lambda: getattr(dcn, name)(*args), reps=10)
            plain_ms = cuda_ms(lambda: PLAIN_DCN_CALLS[name](*args), reps=3, warmup=1)
        rows.append(dict(name=kernel, dims=list(shape), ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
    return rows


def split_gradient(opt: dict, module) -> torch.Tensor:
    """The one-process gradient of opt's first global batch taken as the 2
    ranks take it: each rank's rows (its degradations drawn as the global
    draw's rows) through the model's own step with the update skipped, the
    two gradients averaged as the all-reduce averages them."""
    from dynavsr_tpu_torch.cli.train import (
        build_frozen_estimator,
        noise_range,
        step_generator,
        synthesize_meta_batch,
    )
    from dynavsr_tpu_torch.data.loader import create_dataloader, create_dataset
    from dynavsr_tpu_torch.parallel import mesh

    model = create_model(opt)
    ds = opt["datasets"]["train"]
    batch = next(iter(create_dataloader(create_dataset(ds), ds, opt)))
    n, meta_run = ds["batch_size"], opt["model"] == "video_meta"
    est = build_frozen_estimator(opt, "cuda") if meta_run else None
    grads, orig = [], module.apply_update

    def record(optimizer, params, *args):
        grads.append(torch.cat([p.grad.flatten() for p in params]).detach().clone())
        return torch.zeros(())

    module.apply_update = record
    try:
        for r in range(MULTI_RANKS):
            rows = mesh.batch_rows(n, r, MULTI_RANKS)
            if meta_run:
                model.feed_data(synthesize_meta_batch(
                    step_generator(opt["train"]["manual_seed"] or 0, 1, "cuda"),
                    batch["HR"][rows], SCALE, est, noise_range(opt), (rows.start, n)))
            else:
                model.feed_data({k: v[rows] for k, v in batch.items()
                                 if isinstance(v, np.ndarray)})
            model.optimize_parameters(1)
    finally:
        module.apply_update = orig
    return (grads[0] + grads[1]) / MULTI_RANKS


def multi_rank(rank: int, world: int, port: int, payload: str, out_dir: str) -> None:
    """A rank of 14b-14d (spawned): a gloo group sharing card 0."""
    from dynavsr_tpu_torch.cli.test_dynavsr import run_clips
    from dynavsr_tpu_torch.parallel import mesh
    from dynavsr_tpu_torch.train import meta, trainer

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    mesh.init_dist("pytorch", "cuda", backend="gloo")
    p = torch.load(payload, weights_only=False)
    out = {}
    try:
        vsr = define_G({"network_G": EDVR_M})
        vsr.load_state_dict(p["vsr"])
        est = build_estimator({"nf": MFDN_NF}, SCALE, EDVR_M["nframes"])
        est.load_state_dict(p["est"])
        mesh.replicate(vsr)
        mesh.replicate(est)
        cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
        clips = p["clips"]  # without GT: scoring is not timed
        short = next(c for c, (t, _, _) in MULTI_CLIPS.items() if t < N_WINDOWS)
        run_clips(vsr, est, {short: clips[short]}, cfg, seq=False, **clips_kwargs())  # warm-up
        for seq in (False, True):
            mode = "seq" if seq else "windows"
            reset_all_counts()
            mesh.barrier()
            t0 = time.perf_counter()
            got = run_clips(vsr, est, clips, cfg, seq=seq, **clips_kwargs())
            torch.cuda.synchronize()
            mesh.barrier()
            out[mode] = dict(s=time.perf_counter() - t0, launches=all_counts(),
                             got=None if got is None else sorted(got))
            if got is not None:
                out[mode].update(max_diff={c: float(np.abs(v[0] - p["sr"][mode][c].numpy()).max())
                                           for c, v in got.items()},
                                 losses={c: v[1]["adapt_losses"] for c, v in got.items()})
        del vsr, est, clips
        torch.cuda.empty_cache()
        for tag, module in (("14c", trainer), ("14d", meta)):
            torch.cuda.empty_cache()
            out[tag] = one_step(p[tag], module, check_calls=True)
            kept = out[tag].pop("kept")
            if rank == 0:  # timed while the other rank waits
                out[tag]["timing"] = time_kept(kept)
            del kept
            mesh.barrier()
        torch.save(out, osp.join(out_dir, f"{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def multi_opts(root: str, reds: tuple, est_5f: str, init: str, tag: str) -> dict:
    """14c's and 14d's configs (9a's and 10c's, one iteration, from the
    weights in `init`), named by tag so runs do not share directories."""
    c = train_opt({**TRAIN_RUNS["9a"], "name": f"EDVR_M_REDS_14c_{tag}"}, *reds, root)
    d = meta_opt(reds[0], est_5f, root, name=f"DynaVSR_EDVR_M_REDS_14d_{tag}")
    for o in (c, d):
        o["path"]["pretrain_model_G"] = init
    return {"14c": c, "14d": d}


def phase_multi(smi: str, edvr: dict, reds: tuple, est_5f: str, root: str) -> dict:
    """Phase 14; returns its readings (printed as a `[multi] {json}` line)."""
    import torch.multiprocessing as mp

    from dynavsr_tpu_torch.parallel import mesh
    from dynavsr_tpu_torch.train import meta, trainer
    from dynavsr_tpu_torch.train.checkpoint import save_network

    clips = multi_clips()
    out, sr = phase_multi_clips(smi, edvr, clips)
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)
    init = save_network(osp.join(root, "multi"), 0, edvr["vsr32"])
    ones = multi_opts(root, reds, est_5f, init, "one")
    one = {"14c": one_step(ones["14c"], trainer), "14d": one_step(ones["14d"], meta)}
    split = {"14c": split_gradient(ones["14c"], trainer), "14d": split_gradient(ones["14d"], meta)}
    payload = osp.join(root, "multi", "payload.pt")
    torch.save({"vsr": {k: v.cpu() for k, v in edvr["vsr32"].state_dict().items()},
                "est": {k: v.cpu() for k, v in edvr["est"].state_dict().items()},
                "clips": {c: (lq, None) for c, (lq, _) in clips.items()},
                "sr": {m: {c: torch.from_numpy(a) for c, a in v.items()}
                                       for m, v in sr.items()}, **multi_opts(root, reds, est_5f, init, "two")}, payload)
    del sr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(multi_rank, args=(MULTI_RANKS, mesh.free_port(), payload, osp.join(root, "multi")),
             nprocs=MULTI_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(osp.join(root, "multi", f"{r}.pt"), weights_only=False)
             for r in range(MULTI_RANKS)]
    expect = multi_launches(MULTI_RANKS, cfg)
    for mode in ("windows", "seq"):
        r0 = ranks[0][mode]
        check(r0["got"] == sorted(clips) and ranks[1][mode]["got"] is None,
              f"14b {mode}: rank 0 scored {r0['got']}, rank 1 {ranks[1][mode]['got']}")
        for r, rr in enumerate(ranks):
            check_only(rr[mode]["launches"], expect, f"14b {mode} rank {r}")
        check(all(d <= 1e-4 for d in r0["max_diff"].values()),
              f"14b {mode}: SR vs 14a's {r0['max_diff']} (limit 1e-4)")
        loss_d = max(abs(a - b) / abs(b) for c in clips
                     for a, b in zip(r0["losses"][c], out[mode]["losses"][c]))
        check(loss_d <= 1e-5, f"14b {mode}: rank 0's adaptation losses are {loss_d:.3e} from "
                              f"14a's (limit 1e-5)")
        out[f"14b_{mode}"] = dict(s=r0["s"], s_rank1=ranks[1][mode]["s"], max_diff=r0["max_diff"],
                                  launches=[rr[mode]["launches"] for rr in ranks],
                                  loss_rel_diff=loss_d)
        print(f"[multi] 14b {mode}: {len(clips)} clips on 2 ranks sharing the card (gloo) in "
              f"{r0['s']:.3f} s (14a at world size 1: {out[mode]['s']:.3f} s); max |SR - 14a| "
              f"{max(r0['max_diff'].values()):.3e} (limit 1e-4), rank 0's adaptation losses "
              f"{loss_d:.3e} from 14a's (limit 1e-5); launches a rank "
              f"{ranks[0][mode]['launches']}  [{smi}]")
    for tag, per_update in (("14c", dict.fromkeys(DCN_KERNELS, 4)), ("14d", META_LAUNCHES)):
        a, b, ref = ranks[0][tag], ranks[1][tag], one[tag]
        same = bool(torch.equal(a["after"], b["after"]))
        check(same, f"{tag}: the ranks' weights after the step differ")

        def rel(x, y):
            return float((x - y).norm() / y.norm())

        # The whole-batch gradient moves with fp32 rounding where DCN samples
        # cross a bilinear kink, so it is held within a multiple of how far
        # splitting the batch moves it in one process (gauge_verdict's rule
        # and constants); the split gradient is the ranks' function.
        d_whole, d_split, d_ranks = (rel(a["grad"], ref["grad"]),
                                     rel(split[tag], ref["grad"]), rel(a["grad"], split[tag]))
        limit = GAUGE_FACTOR * d_split + 1e-5
        check(d_whole <= limit, f"{tag}: the all-reduced gradient is {d_whole:.3e} from the "
                                f"one-process gradient (limit {GAUGE_FACTOR} x the split "
                                f"batch's {d_split:.3e} + 1e-5)")
        if tag == "14c":  # the same computation on each half: only the all-reduce differs
            check(d_ranks <= 1e-5, f"14c: the all-reduced gradient is {d_ranks:.3e} from the "
                                   f"one-process split gradient (limit 1e-5)")
        for r, rr in enumerate((a, b)):
            check_only(rr["launches"], per_update, f"{tag} rank {r}")
            bad = [c for c in rr["calls"] if not c["ok"]]
            check(rr["calls"] and not bad, f"{tag} rank {r}: calls off the plain op: {bad[:3]}")
        kinds = sorted({(c["name"], tuple(c["dims"])) for c in a["calls"]})
        worst = max(c["max_abs_err"] / c["tol"] for c in a["calls"] + b["calls"])
        out[tag] = dict(grad_rel_diff=d_whole, split_rel_diff=d_split, vs_split=d_ranks,
                        weights_bitwise=same, launches=a["launches"], timing=a["timing"],
                        one_process_launches=ref["launches"], calls=len(a["calls"]),
                        kinds=[f"{n} {list(d)}" for n, d in kinds], worst_err_over_tol=worst)
        print(f"[multi] {tag}: one step at 2 ranks (half the global batch each): the ranks' "
              f"weights bitwise equal {same}; all-reduced gradient vs one process on the "
              f"global batch |diff|/|grad| {d_whole:.3e} (the one-process split batch "
              f"{d_split:.3e}; limit {limit:.3e}), vs the one-process split gradient "
              f"{d_ranks:.3e}{' (limit 1e-5)' if tag == '14c' else ''}; launches a rank "
              f"{a['launches']}; {len(a['calls'])} kernel calls a rank vs plain, worst "
              f"{worst:.2f} of its tolerance, kinds {out[tag]['kinds']}  [{smi}]")
        for r in a["timing"]:
            print(f"[multi] {tag} {r['name']:22s} {tuple(r['dims'])}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
                  f"roofline {r['bound_ms'] / r['ms']:.1%})  [{smi}]")
    out["spawn_s"] = spawn_s
    return out


# --------------------------------------------------------------- phase 15
# EDVR-L through the entry points, bf16 everywhere its configs put it:
# 15a adapt-and-infer, 15b supervised training, 15c second-order
# meta-training (its K1-K3 and K8-K10 in bf16), 15d EDVR-M's and DUF-16L's
# meta-training in bf16.
EDVR_L = {"which_model_G": "EDVR", "nf": 128, "nframes": 5, "groups": 8, "front_RBs": 5,
          "back_RBs": 40, "w_TSA": True, "dtype": "bfloat16"}  # train_EDVR_L_REDS.yml:39-48
# 15b's global batch: the config's 32, halved where it does not fit the card.
EDVR_L_BATCHES = (32, 16, 8)
EDVR_L_NITER = 3  # 15b and 15c: update 3 is timed (1 and 2 warm up)
# 15c: tools/edvr_l_step_check.py's meta step (batch 2, GT 128: SLR 8, LR 32),
# resumed from the state saved at update 2.
EDVR_L_META = dict(batch=2, gt_size=128, save=2)
BF16_META_NITER = 4  # 15d: updates 3-4 timed
TERM_TRIES = 2  # gauged tries of the bf16 second-order term (second_order_term)
# The bf16 term is read where the float64 term is at least half the meta
# gradient: there the bf16 terms' own rounding is small beside it. Where the
# term is a few percent (the fp32 share), both bf16 terms, the kernels' and
# the plain op's, were mostly rounding on the card (up to 70 x the float64
# term), and their own share picked such alphas.
BF16_TERM_SHARE = 0.5
BF16_ALPHAS = ALPHAS + (100.0, 1000.0)
# The bf16 terms' own floor in the gauge (GAUGE_FLOOR is fp32's): a bf16 meta
# gradient lies a few 1e-2 from the exact one (the CPU test
# test_torch_port_bf16_second_order.py measured the port's 3e-2 from fp32).
BF16_GAUGE_FLOOR = 0.1


def bf16_meta_checks(tag: str, model, batch: dict, gen: torch.Generator, module, plain: dict,
                     expect: dict, swap, redraw=None, std: float = 0.0, keep=()) -> tuple:
    """One meta update of `model` with every kernel call of `module` held
    against its plain version (call_tol's bf16 bounds) and the launches
    against `expect`, then the bf16 second-order term gauged against a
    float64 evaluation of the plain op (second_order_term with TERM_TRIES,
    2 windows a try, at BF16_TERM_SHARE, the meta loss's Charbonnier at
    TERM_CB_EPS), and the same reading with the configs' loss (reported).
    Returns (readings, the kept calls)."""
    model.feed_data(batch)
    model.optimize_parameters()  # warm-up (builds the step)
    calls, kept = checked_calls(model.optimize_parameters, module, plain, keep=keep,
                                by_shape=True)
    by_kernel = {}
    for r in calls:
        n, e = by_kernel.get(r["name"], (0, 0.0))
        by_kernel[r["name"]] = (n + 1, max(e, r["max_abs_err"] / max(r["tol"], 1e-30)))
    bad = [r for r in calls if not r["ok"]]
    print(f"[edvr_l] {tag} one bf16 meta update's kernel calls vs plain: "
          f"{ {k: f'{n} calls, worst {e:.3f} of tol' for k, (n, e) in by_kernel.items()} }")
    check(not bad, f"{tag}: {len(bad)} calls off their plain version: {bad[:3]}")
    called = {k: n for k, n in expect.items() if n}
    check({k: n for k, (n, _) in by_kernel.items()} == called,
          f"{tag}: calls a meta update {by_kernel}")
    check(all(r["dtype"] == "bfloat16" for r in calls if r["name"] in TANGENT_KERNELS),
          f"{tag}: a K8-K10 call was not in bf16")
    del calls
    torch.cuda.empty_cache()
    nb = next(iter(batch.values())).shape[0]
    term_batch = batch if redraw is None else {k: v[:2] for k, v in batch.items()}
    with meta_charbonnier(TERM_CB_EPS):
        term = second_order_term(f"edvr_l {tag}", model, term_batch, gen, swap, redraw, std,
                                 tries=min(TERM_TRIES, nb // 2) if redraw is None else TERM_TRIES,
                                 share=BF16_TERM_SHARE, alphas=BF16_ALPHAS,
                                 floor=BF16_GAUGE_FLOOR, by_f64=True)
    # The configs' loss at the same alpha and the model's own weights: reported.
    configs = term_vs_plain(model, term_batch, term["alpha"], swap, gauge=True)
    print(f"[edvr_l] {tag} with the configs' Charbonnier (eps 1e-12), its own weights, alpha "
          f"{term['alpha']}: term {configs['share']:.3e} of the gradient (float64 "
          f"{configs['share_f64']:.3e}), from float64: kernels {configs['kernel_vs_f64']:.3e}, "
          f"plain {configs['plain_vs_f64']:.3e} (reported)")
    return dict(calls={k: list(v) for k, v in by_kernel.items()}, term=term,
                term_configs_loss=configs), kept


def phase_edvr_l(smi: str, gen: torch.Generator, lq: np.ndarray, gt: np.ndarray, edvr: dict,
                 main_results: dict, reds: tuple, meta: dict, meta2: dict, root: str) -> tuple:
    """15a-15d; returns (measurements, the bf16 K8-K10 timing rows, 15c's
    launches)."""
    from dynavsr_tpu_torch.models.video_base_model import MetaModel, VideoBaseModel

    out = {}
    # 15a: EDVR-L adapt-and-infer on phase 4's clip with phase 4's MFDN.
    vsr = define_G({"network_G": EDVR_L})
    init_weights(vsr, gen)
    cfg = AdaptConfig(n_steps=5, lr=1e-6, optimizer="adam", infer_chunk=INFER_CHUNK)

    def clip():
        return run_clip(vsr, edvr["est"], lq, None, cfg, seq=False, n_frames=EDVR_L["nframes"],
                        padding="reflection", n_adapt=N_WINDOWS)

    clip()  # warm-up: cuDNN plans at nf 128
    reset_all_counts()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sr, res = clip()
    secs = time.perf_counter() - t0  # run_clip returns host arrays: synchronised
    peak = torch.cuda.max_memory_allocated() - held
    counts = {k: v for k, v in all_counts().items() if k in DCN_KERNELS}
    losses = res["adapt_losses"]
    check(len(losses) == 5 and all(math.isfinite(v) for v in losses),
          f"15a: adaptation losses {losses}")
    check(sr.shape == gt.shape and bool(np.isfinite(sr).all()), f"15a: SR {sr.shape}")
    want = main_results["bf16-windows"]["counts"]
    check(counts == want, f"15a: launches {counts}, phase 4's bf16 EDVR-M clip {want}")
    out["15a"] = dict(s_per_clip=secs, frames_per_s=CLIP_T / secs, peak_gib=peak / 2**30,
                      held_gib=held / 2**30, losses=losses, launches=counts,
                      psnr=frame_psnr(sr, gt))
    print(f"[edvr_l] 15a EDVR-L (nf 128, 5 + 40 blocks, Gd 8, bf16) + MFDN run_clip on "
          f"{CLIP_T} frames of {LR_H}x{LR_W}: {secs:.3f} s/clip ({CLIP_T / secs:.2f} frames/s), "
          f"peak {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} held; losses "
          f"{[f'{v:.6f}' for v in losses]}; launches {counts}  [{smi}]")
    del vsr, sr
    torch.cuda.empty_cache()

    # 15b: supervised training, train_EDVR_L_REDS.yml's fields.
    for batch in EDVR_L_BATCHES:
        run = dict(name=f"EDVR_L_REDS_b{batch}", groups=8, dtype="bfloat16",
                   restart_weights=[1, 1, 1], niter=EDVR_L_NITER, net=EDVR_L, batch=batch)
        try:
            m = train_and_resume("15b", lambda res, run=run: train_opt(run, *reds, root, res),
                                 EDVR_L_NITER, None, VideoBaseModel,
                                 per_update=dict.fromkeys(DCN_KERNELS, 4))
            break
        except torch.cuda.OutOfMemoryError:
            print(f"[edvr_l] 15b: a global batch of {batch} does not fit the card")
            torch.cuda.empty_cache()
    l_pix = [r["l_pix"] for r in m["recs"]]
    check(all(math.isfinite(v) for v in l_pix), f"15b: l_pix {l_pix}")
    out["15b"] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
    out["15b"].update(batch=batch, batch_cut_from=32, l_pix=l_pix,
                      samples_per_s=batch / m["s_per_iter"])
    print(f"[edvr_l] 15b EDVR-L supervised (global batch {batch} of the config's 32, 5 x 64^2 "
          f"LQ -> 256^2): {EDVR_L_NITER} updates in {m['run_s']:.1f} s; update 3 "
          f"{m['s_per_iter']:.4f} s ({batch / m['s_per_iter']:.2f} samples/s); loader wait "
          f"{m['mean_data_wait_s'] * 1e3:.1f} ms; peak {m['peak_gib']:.2f} GiB above the "
          f"{m['held_gib']:.2f} held; l_pix {[round(v, 5) for v in l_pix]}; launches an update "
          f"{m['per_update']}  [{smi}]")
    del m
    torch.cuda.empty_cache()

    # 15c: second-order meta-training of EDVR-L (train_dynavsr's path).
    reds_gt, est_5f = reds[0], meta["est_5f"]
    m = train_and_resume("15c", lambda res: meta_opt(
        reds_gt, est_5f, root, res, name="DynaVSR_EDVR_L_REDS", net=EDVR_L,
        gt_size=EDVR_L_META["gt_size"], batch=EDVR_L_META["batch"], niter=EDVR_L_NITER,
        save=EDVR_L_META["save"]), EDVR_L_NITER, EDVR_L_META["save"], MetaModel,
        per_update=META_LAUNCHES)
    recs = m["recs"]
    check(all(math.isfinite(r[k]) for r in recs for k in ("l_outer", "l_inner", "grad_norm")),
          f"15c: {recs}")
    launches = m["launches"]
    out["15c"] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
    out["15c"].update(l_outer=[r["l_outer"] for r in recs],
                      grad_norm=[r["grad_norm"] for r in recs])
    print(f"[edvr_l] 15c EDVR-L meta (batch 2 x 5, SLR 8^2 / LR 32^2 / HR 128^2, alpha 1e-5, "
          f"second order, bf16, MFDN in the loop): {EDVR_L_NITER} updates in {m['run_s']:.1f} s; "
          f"update 3 {m['s_per_iter']:.4f} s; peak {m['peak_gib']:.2f} GiB above the "
          f"{m['held_gib']:.2f} held; l_outer {out['15c']['l_outer']}; resumed at "
          f"{EDVR_L_META['save']} bitwise; launches an update {m['per_update']}  [{smi}]")
    model = trained_model(m["opt"])
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in m["first_batch"].items()}
    del m
    readings, kept = bf16_meta_checks(
        "15c", model, batch, gen, dcn, PLAIN_DCN_CALLS, META_LAUNCHES,
        (edvr_module, "deform_conv2d", plain_dcn), lambda n: "conv_offset_mask.weight" in n,
        OFFSET_STD, keep=TANGENT_KERNELS)
    out["15c"].update(readings)
    rows = tangent_rows(kept, smi)
    del model, kept
    torch.cuda.empty_cache()

    # 15d: 10c's EDVR-M and 11b's DUF-16L meta-trained in bf16.
    runs = {"15d-EDVR-M": (lambda res: meta_opt(
                reds_gt, est_5f, root, res, name="DynaVSR_EDVR_M_REDS_bf16",
                net={**EDVR_M, "dtype": "bfloat16"}, niter=BF16_META_NITER, save=None),
             dcn, PLAIN_DCN_CALLS, META_LAUNCHES, (edvr_module, "deform_conv2d", plain_dcn),
             lambda n: "conv_offset_mask.weight" in n, meta["10c"]["s_per_iter"]),
            "15d-DUF-16L": (lambda res: meta2_opt(
                "11b", meta["vimeo_lmdb"], meta["10a"]["final"], root, res, dtype="bfloat16",
                niter=BF16_META_NITER, save=None),
             duf_filter, {n: PLAIN_BN_CALLS[n] for n in DUF_KERNELS}, META2_LAUNCHES["11b"],
             META2_RUNS["11b"]["swap"], None, meta2["11b"]["s_per_iter"])}
    for tag, (make_opt, module, plain, expect, swap, redraw, fp32_s) in runs.items():
        m = train_and_resume(tag, make_opt, BF16_META_NITER, None, MetaModel, per_update=expect)
        recs = m["recs"]
        check(all(math.isfinite(r[k]) for r in recs for k in ("l_outer", "l_inner", "grad_norm")),
              f"{tag}: {recs}")
        out[tag] = {k: v for k, v in m.items() if k not in ("opt", "recs", "first_batch")}
        out[tag].update(fp32_s_per_iter=fp32_s, l_outer=[r["l_outer"] for r in recs])
        print(f"[edvr_l] {tag} bf16 meta: {BF16_META_NITER} updates in {m['run_s']:.1f} s; "
              f"updates 3-{BF16_META_NITER} {m['s_per_iter']:.4f} s each (fp32, phases 10 / 11: "
              f"{fp32_s:.4f} s); peak {m['peak_gib']:.2f} GiB above the {m['held_gib']:.2f} "
              f"held; launches an update {m['per_update']}  [{smi}]")
        model = trained_model(m["opt"])
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in m["first_batch"].items()}
        del m
        readings, _ = bf16_meta_checks(tag, model, batch, gen, module, plain, expect, swap,
                                       redraw, OFFSET_STD)
        out[tag].update(readings)
        del model
        torch.cuda.empty_cache()
    return out, rows, launches


# ---------------------------------------------------------------- phase 16
# The JAX tool's toy-shape leg (tools/tpu_queue_r5d.sh:38-44): EDVR nf 32, 2 +
# 3 blocks, Gd 8, bf16 nets, seed 0, iso:1.8, 600 + 600 iterations, 20
# adaptation steps at lrs 1e-6 and 1e-5, MFDN; run with meta 150, then
# meta 0 from the same root (the trained VSR net and MFDN reused).
BN_QUALITY_ARGS = ["--kernels", "iso:1.8", "--seed", "0", "--iters", "600", "--mfdn-iters", "600",
                   "--adapt-steps", "20", "--adapt-lrs", "1e-6", "1e-5", "--estimator", "mfdn"]
QUALITY_ARGS = BN_QUALITY_ARGS + ["--nf", "32", "--front-rbs", "2", "--back-rbs", "3",
                                  "--groups", "8"]
QUALITY_META_ITERS = 150
# The JAX package's record of the same leg on a TPU (PSNR, not time):
# results_r05/blind_est_mfdn.log.
JAX_QUALITY = {"mean_gain_db": 3.94, "psnr_bicubic_matched": 38.52,
               "sfdn_mean_gain_db": 3.84, "source": "results_r05/blind_est_mfdn.log"}
DCN_WRAPPERS = ("_fwd", "dcn_bwd_data", "dcn_bwd_weight")
# The TOF and DUF legs (BN_QUALITY_ARGS with --arch, meta 150 only): the
# wrappers of the module their kernels sit in, the kernels the meta run must
# launch (K12 only where a flow cotangent is not all zero: 0-2400 a run at
# the protocol's trained SpyNet, PERF.md §6), and the JAX package's
# records of the same legs on a TPU (PSNR, not time; bn_mode auto =
# train_ema).
BN_QUALITY = {
    "tof": dict(module=warp, launched=("warp_fwd", "warp_bwd"),
                jax={"mean_gain_db": 2.4808, "psnr_bicubic_matched": 36.4754,
                     "grad_stats_mean_gain_db": 1.3015,
                     "source": "results_r03/bn_mode_tof.txt (train_ema)"}),
    "duf": dict(module=duf_filter, launched=DUF_KERNELS,
                jax={"mean_gain_db": 3.5575, "psnr_bicubic_matched": 37.2774,
                     "grad_stats_mean_gain_db": 3.5613,
                     "source": "results_r03/blind_robust_duf_s0.json (iso1.8)"}),
}
WRAPPERS = {warp: ("warp_fwd", "warp_bwd", "warp_fwd_tangent", "warp_bwd_tangent"),
            duf_filter: DUF_KERNELS}
# The K12 launches of the TOF leg's meta run held against plain and float64
# as they happen (16-2400 a run; checking them all cost ~30 s on the card).
WATCHED_CALLS = 256


# The wrong kernel that phase 16 measures its bounds against: the plain
# version with every offset 2^-6 px off.
OFFSET_BUG_PX = 2.0 ** -6


def ratio_spread(ratios: list) -> dict:
    """The distribution of a kernel's calls' error / bound: count, median,
    90th percentile, largest, and how many lie above 0.9 and above 1."""
    r = np.asarray(ratios, dtype=np.float64)
    return dict(n=int(r.size), median=float(np.median(r)), p90=float(np.percentile(r, 90)),
                max=float(r.max()), above_0_9=int((r > 0.9).sum()), above_1=int((r > 1).sum()))


def trained_spread(tag: str, calls: list) -> dict:
    """Each kernel's spread of error / bound over `calls` (checked_calls rows
    gauged against float64), its largest float64 distances and the calls the
    gauge held; printed. Raises if a call is off its plain version and
    float64 (f64_held)."""
    spread = {}
    for k in dict.fromkeys(r["name"] for r in calls):
        mine = [r for r in calls if r["name"] == k]
        spread[k] = dict(ratio=ratio_spread([r["max_abs_err"] / max(r["tol"], 1e-30)
                                             for r in mine]),
                         kernel_vs_f64_max=max(r["kernel_vs_f64"] for r in mine),
                         plain_vs_f64_max=max(r["plain_vs_f64"] for r in mine),
                         held_by_f64=sum(r["max_abs_err"] > r["tol"] and r["ok"] for r in mine))
        q, v = spread[k]["ratio"], spread[k]
        print(f"[quality] {tag}: {k} {q['n']} calls vs plain at trained weights, error / bound "
              f"median {q['median']:.3f} p90 {q['p90']:.3f} max {q['max']:.3f} (> 0.9: "
              f"{q['above_0_9']}, > 1: {q['above_1']}, held by the float64 gauge: "
              f"{v['held_by_f64']}); largest distance from float64: kernel "
              f"{v['kernel_vs_f64_max']:.3e}, plain {v['plain_vs_f64_max']:.3e} (of the "
              f"largest value)")
    bad = [r for r in calls if not r["ok"]]
    check(not bad, f"{tag}: {len(bad)} calls off their plain version and float64: {bad[:3]}")
    return spread


def checked_trained(tag: str, run, names, smi: str) -> tuple:
    """run() with every call of the DCN wrappers `names` held against its
    plain version and gauged against float64 (checked_calls with f64:
    call_tol's bounds, a call past its bound held by f64_held); each
    kernel's spread of error / bound and its largest float64 distances;
    then the first call of each wrapper at its largest shape timed beside
    its plain version and its bound, and read beside a wrong kernel (the
    plain version with its offsets OFFSET_BUG_PX off): its error / bound
    and its distance from float64, where both checks would fail it if it
    stood far beyond 1 and beyond the plain version's. Returns the reading
    and the timing rows."""
    calls, kept = checked_calls(run, dcn, {n: PLAIN_DCN_CALLS[n] for n in names}, keep=names,
                                by_shape=True, f64=True)
    offs = [r["offset_absmean_px"] for r in calls if r["name"] == "dcn_fwd"]
    spread = trained_spread(tag, calls)
    print(f"[quality] {tag}: K1 offsets mean |value| {np.mean(offs):.4f} px (calls "
          f"{min(offs):.4f}-{max(offs):.4f})")
    check(set(spread) == {"dcn_fwd" if n == "_fwd" else n for n in names},
          f"{tag}: calls {list(spread)}")
    rows = []
    for name in names:
        shape = max((k[1] for k in kept if k[0] == name), key=lambda s: (s[2] * s[3], s[0]))
        args = kept[(name, shape)]
        gd, dtype, kname = args[-1], args[0].dtype, "dcn_fwd" if name == "_fwd" else name
        fn, plain = getattr(dcn, name), PLAIN_DCN_CALLS[name]
        out = fn(*args)
        got = [out[0]] if name == "_fwd" else (
            [out] if torch.is_tensor(out) else [t for t in out if t is not None])
        with torch.no_grad():
            want, exact = plain(*args), plain(*_f64(*args))
            wrong = plain(args[0], args[1] + OFFSET_BUG_PX, *args[2:])
        scale, tol = max(float(w.abs().max()) for w in want), call_tol(name, args)
        dist = lambda a, b: max(float((x.double() - y.double()).abs().max())  # noqa: E731
                                for x, y in zip(a, b)) / scale
        err, plain_f64, wrong_f64 = dist(got, want), dist(want, exact), dist(wrong, exact)
        wrong_ratio = dist(wrong, want) / tol
        bound = (tangent_bound if kname in TANGENT_KERNELS else dcn_bound)(kname, shape, gd,
                                                                             dtype)
        ms = cuda_ms(lambda: fn(*args), reps=10)
        plain_ms = cuda_ms(lambda: plain(*args), reps=3, warmup=1)
        row = dict(name=kname, run=tag, label=f"{shape[0]}x{shape[2]}x{shape[3]}",
                   dims=list(shape), gd=gd, dtype=str(dtype)[6:], max_abs_err=err * scale,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                   bytes=bound[2], flops=bound[3], roofline=bound[0] / ms, library_ms=None,
                   offset_absmean_px=float(np.mean(offs)), error_over_bound=err / tol,
                   plain_vs_f64=plain_f64, wrong_offsets_over_bound=wrong_ratio,
                   wrong_offsets_vs_f64=wrong_f64)
        rows.append(row)
        print(f"[timing] {kname:22s} {tag} {row['label']} Gd={gd} {row['dtype']} max|err| "
              f"{err * scale:.3e} ({err / tol:.3f} of its bound; offsets {OFFSET_BUG_PX} px "
              f"off: {wrong_ratio:.1f} of it, {wrong_f64:.3e} from float64 against plain's "
              f"{plain_f64:.3e})  {ms:.4f} ms  plain {plain_ms:.3f} ms  bound {bound[0]:.4f} ms "
              f"({bound[1]})  roofline {row['roofline']:.1%}  [{smi}]")
    return dict(calls=spread, offset_absmean_px=float(np.mean(offs)),
                offset_absmean_px_range=[min(offs), max(offs)]), rows


def checked_trained_bn(tag: str, run, module, smi: str, draw_k12: bool = False) -> tuple:
    """run() with every call of `module`'s K4 / K5 / K12 (or K6 / K7)
    wrappers held against its plain version (PLAIN_BN_CALLS) and gauged
    against float64, as checked_trained does for the DCN (call_tol: 1e-4 of
    the plain result's largest value in fp32, 2^-7 for K7's bf16 grad
    filters; a call past it held by f64_held); every launch of the run is
    one checked call. With `draw_k12` (TOF's meta update, whose flow
    cotangents are mostly all zero at the protocol's trained weights, so
    that it launches K12 seldom or never), K12 then runs on the trained
    inputs of every K5 call
    of the run with a flow cotangent drawn N(0, 1), T asked for as in a
    meta update, each call held the same way. Then the largest call of each
    wrapper checked again at phase 3's tolerances and timed beside its
    plain version, its library call where there is one, and its bound: K4
    / K5 by warp_against_plain (grad flow, as TOF's path asks), K12 by
    tangent_timing_row, K6 / K7 by duf_against_plain (grad filters).
    Returns the reading (with the flows' mean |value| in px and the share
    of samples off the frame for the warp) and the timing rows."""
    names = WRAPPERS[module]
    reset_all_counts()
    k5_calls, k5 = [], warp.warp_bwd
    if draw_k12:
        def k5_recording(x, flow, grad_out, need_x):
            k5_calls.append((x.detach().clone(), flow.detach().clone(), grad_out.detach().clone()))
            return k5(x, flow, grad_out, need_x=need_x)

        warp.warp_bwd = k5_recording
    try:
        calls, kept = checked_calls(run, module, {n: PLAIN_BN_CALLS[n] for n in names},
                                    keep=names, f64=True)
    finally:
        warp.warp_bwd = k5
    launched = {n: all_counts()[n] for n in names}
    spread = trained_spread(tag, calls)
    check({k: v["ratio"]["n"] for k, v in spread.items()} == {k: n for k, n in launched.items()
                                                                if n},
          f"{tag}: checked calls {list(spread)} against launches {launched}")
    out = dict(calls=spread, launches=launched)
    flows = [(r["flow_absmean_px"], r["flow_off_frame"]) for r in calls if "flow_absmean_px" in r]
    if flows:
        px, off = [f for f, _ in flows], [o for _, o in flows]
        out.update(flow_absmean_px=float(np.mean(px)), flow_absmean_px_median=float(
            np.median(px)), flow_absmean_px_range=[min(px), max(px)],
            flow_off_frame=float(np.mean(off)))
        print(f"[quality] {tag}: flows mean |value| {np.mean(px):.4f} px (calls: median "
              f"{np.median(px):.4f}, {min(px):.4f}-{max(px):.4f}), {np.mean(off):.1%} of the "
              f"samples off the frame; trained K1 offsets read 0.24-0.32 px")
    if draw_k12:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        drawn = [(x, f, g, torch.randn(f.shape, generator=gen, device=f.device), False, True)
                 for x, f, g in k5_calls]
        reset_all_counts()
        k12, kept12 = checked_calls(lambda: [warp.warp_bwd_tangent(*a) for a in drawn], warp,
                                    {"warp_bwd_tangent": PLAIN_BN_CALLS["warp_bwd_tangent"]},
                                    keep=("warp_bwd_tangent",), f64=True)
        check(len(k12) == len(k5_calls) == all_counts()["warp_bwd_tangent"] > 0,
              f"{tag}: {len(k12)} K12 calls on {len(k5_calls)} K5 calls' inputs")
        out["k12_drawn_cotangent"] = trained_spread(f"{tag}, K12 on each K5 call's inputs with "
                                                    f"a drawn flow cotangent", k12)
        kept = {**kept12, **kept}  # a K12 launch of the run itself stays the one timed
    rows = []
    for name, args in kept.items():
        label = warp_label("trained", args[0].shape)
        if name == "warp_bwd_tangent":
            got = [tangent_timing_row(args, smi)]
        elif name in ("warp_fwd", "warp_bwd"):
            got = warp_against_plain(label, args[0], args[1],
                                     args[2] if name == "warp_bwd" else None, need_x=False,
                                     timed=True)
        else:
            got = duf_against_plain(label, args[0], args[1],
                                    args[2] if name == "duf_bwd" else None, need_x=False,
                                    timed=True)
        for row in got:
            if row["name"] == name:
                row.update(run=tag, flow_absmean_px=out.get("flow_absmean_px"))
                rows.append(row)
    return out, rows


def trained_clip(record: dict, details: dict, device):
    """The iso1.8 leg's adaptation at its best lr, as the protocol ran it:
    the net it adapted (meta-trained) and its MFDN on `device`, the leg's
    first val clip, and the AdaptConfig (bn_mode as configured)."""
    from dynavsr_tpu_torch.data.lmdb_dataset import LmdbClipIndex
    from dynavsr_tpu_torch.train.checkpoint import load_pretrained

    best = details["opts"][f"adapt_iso1.8_{record['per_kernel']['iso1.8']['best_adapt_lr']:g}"]
    vsr = define_G(best, device)
    load_pretrained(vsr, details["adapt_init_ckpt"])
    est = build_estimator(best["network_E"], SCALE, details["n_frames"], device)
    load_pretrained(est, details["mfdn_ckpt"])
    lq_index = LmdbClipIndex(f"{details['data']}/val/LQ_iso1.8.lmdb")
    clip = lq_index.names[0]
    lq = np.stack([lq_index.read_frame(k) for k in lq_index.clips[clip]])
    cfg = AdaptConfig(n_steps=best["adapt"]["n_steps"], lr=best["adapt"]["lr"],
                      optimizer="adam", infer_chunk=INFER_CHUNK,
                      bn_mode=best["adapt"]["bn_mode"])
    return lambda: run_clip(vsr, est, lq, None, cfg, seq=False, n_frames=details["n_frames"],
                            padding="reflection", n_adapt=best["adapt"]["n_windows"],
                            device=device)


def trained_meta_model(details: dict, batch: dict, device):
    """A MetaModel of the protocol's meta leg at its meta-trained weights,
    fed the meta run's first batch, its step built by one update."""
    meta_opt = details["opts"]["train_meta"]
    model = create_model({**meta_opt, "path": {
        **meta_opt["path"], "pretrain_model_G": details["adapt_init_ckpt"]}}, device)
    model.feed_data({k: torch.as_tensor(v, device=device) for k, v in batch.items()})
    model.optimize_parameters()  # warm-up (builds the step)
    return model


def quality_run(tag: str, argv: list, device, jax: dict, smi: str, watch=None) -> tuple:
    """One run of the protocol through its `run` on `device`, launches
    counted from 0 and the meta run's first batch kept; prints the gain
    beside JAX's record. `watch` (module, name): the first WATCHED_CALLS
    calls of that wrapper in the run held against its plain version and
    float64 (checked_calls), their rows in details['watched']. Returns
    (record, details, that batch, launches, seconds)."""
    from dynavsr_tpu_torch.models.video_base_model import MetaModel
    from dynavsr_tpu_torch.tools import blind_adaptation_check as protocol

    args = protocol.build_parser().parse_args(argv)
    reset_all_counts()
    t0 = time.perf_counter()
    with TrainingProbe(keep={1}, cls=MetaModel) as probe:
        if watch is None:
            record, details = protocol.run(args, device)
        else:
            got = []
            watched, _ = checked_calls(lambda: got.append(protocol.run(args, device)), watch[0],
                                       {watch[1]: PLAIN_BN_CALLS[watch[1]]}, f64=True,
                                       max_calls=WATCHED_CALLS)
            (record, details), details["watched"] = got[0], watched
    secs, launches = time.perf_counter() - t0, all_counts()
    leg = record["per_kernel"]["iso1.8"]
    print(f"[quality] {tag}: mean gain {record['mean_gain_db']:+.4f} dB (blind "
          f"{leg['psnr_no_adapt']:.4f} -> adapted {leg['psnr_adapted']:.4f} at lr "
          f"{leg['best_adapt_lr']:g}), matched bicubic {record['psnr_bicubic_matched']:.4f} dB; "
          f"MFDN probe rmse {leg['mfdn_rmse_vs_true_slr']:.5f} vs bicubic "
          f"{leg['bicubic_rmse_vs_true_slr']:.5f}; JAX (TPU record, {jax['source']}): gain "
          f"{jax['mean_gain_db']} dB, matched {jax['psnr_bicubic_matched']} dB; {secs:.1f} s, "
          f"legs { {k: round(v, 1) for k, v in details['seconds'].items()} }  [{smi}]")
    check(all(math.isfinite(v) for v in (record["mean_gain_db"], leg["psnr_adapted"],
                                         record["psnr_bicubic_matched"])), f"{tag}: {record}")
    return record, details, probe.batches.get(1), launches, secs


def phase_quality(smi: str, root: str, device=None) -> tuple:
    """16: the blind-adaptation quality protocol
    (dynavsr_tpu_torch/tools/blind_adaptation_check.py) at the JAX tool's
    toy-shape leg, through the tool's functions, twice from one root: meta
    150 (the protocol's PASS checked), then meta 0 (only the tests run
    again). Then at trained weights: every K1-K3 call of one adapted clip
    of the iso1.8 leg (the meta-trained EDVR, its best lr) and every K1-K3,
    K8-K10 call of one meta update, held against the plain version, gauged
    against float64 and timed (checked_trained). Then the TOF and DUF legs
    (quality_bn_leg). Needs only the card and a scratch directory: a script
    that calls phase_device and phase_build can run it alone. Returns (the
    reading, the timing rows, each kernel's launches in the meta run of its
    backbone)."""
    qroot, device = osp.join(root, "quality"), resolve_device(device)
    out, runs = {"jax": JAX_QUALITY}, {}
    for meta_iters in (QUALITY_META_ITERS, 0):
        runs[meta_iters] = quality_run(
            f"16 meta {meta_iters}", QUALITY_ARGS + ["--meta-iters", str(meta_iters), "--root",
                                                     qroot], device, JAX_QUALITY, smi)
        record, details, _, launches, secs = runs[meta_iters]
        out[f"meta{meta_iters}"] = dict(record=record, seconds=secs, legs=details["seconds"],
                                        launches=launches)
    record, details, batch, launches, _ = runs[QUALITY_META_ITERS]
    check(details["mean_gain_db"] > 0.05,
          f"16: the meta run's mean adaptation gain {details['mean_gain_db']:.4f} dB is not "
          f"above 0.05 dB (the protocol's PASS)")
    out["meta_effect_db"] = record["mean_gain_db"] - runs[0][0]["mean_gain_db"]
    check(launches["dcn_fwd"] > 0 and all(launches[k] > 0 for k in TANGENT_KERNELS),
          f"16: the meta run launched {launches}")

    # Every K1-K3 call of one adapted clip (the iso1.8 leg's first val clip,
    # the meta-trained EDVR at the best lr), at trained weights.
    out["adapted_clip"], rows = checked_trained("16 adapted clip",
                                                trained_clip(record, details, device),
                                                DCN_WRAPPERS, smi)

    # Every K1-K3, K8-K10 call of one meta update at the meta-trained weights.
    model = trained_meta_model(details, batch, device)
    out["meta_update"], meta_rows = checked_trained(
        "16 meta update", model.optimize_parameters, DCN_WRAPPERS + TANGENT_KERNELS, smi)
    del model
    torch.cuda.empty_cache()
    n_calls = {k: v["ratio"]["n"] for k, v in out["meta_update"]["calls"].items()}
    check(n_calls["dcn_fwd"] == META_LAUNCHES["dcn_fwd"]
          and all(n_calls[k] == META_LAUNCHES[k] for k in TANGENT_KERNELS),
          f"16: a meta update's calls {out['meta_update']['calls']}")
    print(f"[quality] 16 gain with meta {QUALITY_META_ITERS} {record['mean_gain_db']:+.4f} dB, "
          f"without {runs[0][0]['mean_gain_db']:+.4f} dB (meta leg {out['meta_effect_db']:+.4f}"
          f" dB); JAX's record {JAX_QUALITY['mean_gain_db']} dB with meta "
          f"{QUALITY_META_ITERS}  [{smi}]")
    launches = {k: launches[k] for k in DCN_KERNELS + TANGENT_KERNELS}
    rows += meta_rows
    for arch in BN_QUALITY:
        out[arch], arch_rows, arch_launches = quality_bn_leg(arch, smi, root, device)
        rows += arch_rows
        launches.update(arch_launches)
    return out, rows, launches


def quality_bn_leg(arch: str, smi: str, root: str, device) -> tuple:
    """16 for TOF or DUF: the protocol with --arch at the JAX tool's leg
    (BN_QUALITY_ARGS, 600 + 600 iterations, meta 150, bn_mode auto =
    train_ema), PASS checked and the gain printed beside JAX's record; then
    every K4 / K5 / K12 (K6 / K7) call of one adapted clip and of one meta
    update at the trained weights held against the plain version, gauged
    against float64 and the largest of each timed (checked_trained_bn).
    Returns (the reading, the timing rows, the meta run's launches of the
    backbone's kernels)."""
    spec, tof = BN_QUALITY[arch], arch == "tof"
    record, details, batch, launches, secs = quality_run(
        f"16 {arch} meta {QUALITY_META_ITERS}",
        BN_QUALITY_ARGS + ["--arch", arch, "--meta-iters", str(QUALITY_META_ITERS), "--root",
                           osp.join(root, f"quality_{arch}")], device, spec["jax"], smi,
        watch=(warp, "warp_bwd_tangent") if tof else None)
    check(details["mean_gain_db"] > 0.05,
          f"16 {arch}: the mean adaptation gain {details['mean_gain_db']:.4f} dB is not above "
          f"0.05 dB (the protocol's PASS)")
    check(all(launches[k] > 0 for k in spec["launched"]),
          f"16 {arch}: the meta run launched {launches}")
    out = dict(record=record, seconds=secs, legs=details["seconds"], launches=launches,
               jax=spec["jax"])
    if tof:  # K12's launches in the meta leg (its flow cotangents are often all zero)
        watched = details.pop("watched")
        check(len(watched) == min(launches["warp_bwd_tangent"], WATCHED_CALLS),
              f"16 tof: {len(watched)} K12 calls checked of {launches['warp_bwd_tangent']}")
        out["meta_leg_k12"] = trained_spread(
            f"16 tof meta leg, the first {len(watched)} of {launches['warp_bwd_tangent']} K12 "
            f"launches", watched) if watched else {}
    out["adapted_clip"], rows = checked_trained_bn(
        f"16 {arch} adapted clip", trained_clip(record, details, device), spec["module"], smi)
    model = trained_meta_model(details, batch, device)
    out["meta_update"], meta_rows = checked_trained_bn(
        f"16 {arch} meta update", model.optimize_parameters, spec["module"], smi, draw_k12=tof)
    del model
    torch.cuda.empty_cache()
    print(f"[quality] 16 {arch} gain with meta {QUALITY_META_ITERS} "
          f"{record['mean_gain_db']:+.4f} dB; JAX's record {spec['jax']['mean_gain_db']} dB "
          f"({spec['jax']['source']})  [{smi}]")
    return out, rows + meta_rows, {k: launches[k] for k in WRAPPERS[spec["module"]]}


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
    edvr_launches, main_results, profiles, calls, edvr_ctx = phase_main(smi, gen, lq, gt)
    tof_launches, tof_results, tof_profiles, warp_calls, tof_ctx = phase_bn_net(
        "tof", TOF_G, TOF_FRAMES, WARP_KERNELS, warp_launches_per_clip,
        (tof_module, "warp_nchw", grid_sample_ref.warp_nchw), smi, gen, lq, gt,
        padding="reflection", crop=0)
    with torch.no_grad():  # DUF's blur-matched LR of the same HR clip
        duf_lq = duf_downsample(torch.as_tensor(gt, device="cuda"), SCALE).cpu().numpy()
    check(duf_lq.shape == lq.shape, f"duf_downsample gave {duf_lq.shape}, not {lq.shape}")
    duf_launches, duf_results, duf_profiles, duf_calls, duf_ctx = phase_bn_net(
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
    reds_8a = surface.pop("_8a")
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
        t_tiles = time.perf_counter()
        tiles = phase_tiles(smi, gen, dict(duf_ctx, lq=duf_lq), reds_8a)
        tiles["seconds"] = time.perf_counter() - t_tiles
        print(f"[tiles] phase 12 took {tiles['seconds']:.1f} s")
        t_stream = time.perf_counter()
        stream = phase_stream(smi, gen, lq, duf_lq, edvr_ctx, tof_ctx, duf_ctx,
                              osp.join(root, "trace"))
        stream["seconds"] = time.perf_counter() - t_stream
        print(f"[stream] phase 13 took {stream['seconds']:.1f} s")
        t_multi = time.perf_counter()
        multi = phase_multi(smi, edvr_ctx, (reds_gt, reds_lq), meta["est_5f"], root)
        multi["seconds"] = time.perf_counter() - t_multi
        print(f"[multi] phase 14 took {multi['seconds']:.1f} s")
        t_large = time.perf_counter()
        edvr_l, edvr_l_rows, edvr_l_launches = phase_edvr_l(
            smi, gen, lq, gt, edvr_ctx, main_results, (reds_gt, reds_lq), meta, meta2, root)
        edvr_l["seconds"] = time.perf_counter() - t_large
        print(f"[edvr_l] phase 15 took {edvr_l['seconds']:.1f} s")
        t_quality = time.perf_counter()
        quality, quality_rows, quality_launches = phase_quality(smi, root)
        quality["seconds"] = time.perf_counter() - t_quality
        print(f"[quality] phase 16 took {quality['seconds']:.1f} s")
    rows += train_rows + meta_rows + meta2_rows + edvr_l_rows + quality_rows
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
    # The bf16 K8-K10 (phase 15c: EDVR-L's meta update, its largest call, the
    # inner step's 10 SLR frames of 8x8 at 128 channels; launches of 15c's run).
    for name in TANGENT_KERNELS:
        source, _, replaces = KERNELS[name]
        row = next(r for r in edvr_l_rows if r["name"] == name and r["label"] == "meta 10x8x8")
        kernels.append({"name": f"{name}_bf16", "route": "cuda", "source": source,
                        "replaces": replaces, "launches": edvr_l_launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": None, "dtype": "bfloat16",
                        "kernel_ms": row["kernel_ms"], "host_us": row["host_us"],
                        "kernel_roofline": row["kernel_roofline"]})
    # Phase 16, at the quality protocol's trained weights (bf16 nets): the
    # largest K1-K3 call of one adapted clip and K1-K3, K8-K10 call of one
    # meta update of the EDVR leg, the largest K4 / K5 / K12 (K6 / K7) calls
    # of the TOF (DUF) leg's; launches of the meta run of each backbone.
    for row in quality_rows:
        source, _, replaces = KERNELS[row["name"]]
        where = "adapt" if row["run"].endswith("adapted clip") else "meta"
        if not quality_launches[row["name"]]:
            print(f"[quality] {row['name']}_trained_{where}: no launch in its meta run (checked "
                  f"and timed on drawn cotangents); not in the kernels line")
            continue
        kernels.append({"name": f"{row['name']}_trained_{where}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": quality_launches[row["name"]],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
                        "dtype": row["dtype"], "dims": row["dims"],
                        **{k: row[k] for k in ("offset_absmean_px", "flow_absmean_px",
                                               "kernel_ms", "host_us") if row.get(k) is not None}})
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": smi, "kernels": rows, "main": main_results, "tof": tof_results,
                       "duf": duf_results, "surface": surface, "train": training,
                       "meta": meta, "meta2": meta2, "tiles": tiles, "stream": stream,
                       "multi": multi, "edvr_l": edvr_l, "quality": quality,
                       "seconds": time.perf_counter() - t_start}, f,
                      indent=1)
    print("[train] " + json.dumps(training))
    print("[meta] " + json.dumps(meta, default=str))
    print("[meta2] " + json.dumps(meta2, default=str))
    print("[tiles] " + json.dumps(tiles, default=str))
    print("[stream] " + json.dumps(stream, default=str))
    print("[multi] " + json.dumps(multi, default=str))
    print("[edvr_l] " + json.dumps(edvr_l, default=str))
    print("[quality] " + json.dumps(quality, default=str))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
