"""The yardstick's arithmetic: the H100's published peaks, the least time
a DCN kernel launch could take, and the labels of device kernel names.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit: 67
TFLOP/s float32 off the tensor cores (the program runs IEEE float32: TF32
is off), 989 TFLOP/s bf16, 3.35 TB/s of HBM. A share is reported against
these, with the card's power limit beside it (the result's `device`).

`dcn_bound` and `tangent_bound` are frozen copies of chip_smoke.py's
functions of the same names: each input read once and each output written
once, operations the 2*B*HW*C*Cout*9 contraction (Cout = C, as in EDVR's
DCNs). `LABELS` / `kernel_label` are frozen from
dynavsr_tpu_torch/tools/profile_ops.py.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
_DT = {torch.float32: "fp32", torch.bfloat16: "bf16"}


def dtype_name(dtype) -> str:
    return _DT[dtype] if isinstance(dtype, torch.dtype) else dtype


def dcn_bound(name: str, shape, gd: int, dtype) -> float:
    """Least seconds of one K1 (dcn_fwd), K2 (dcn_bwd_data) or K3
    (dcn_bwd_weight) launch on x of `shape` (B, C, H, W)."""
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
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name(dtype)])


def tangent_bound(name: str, shape, gd: int, dtype) -> float:
    """Least seconds of one K8 (dcn_fwd_tangent), K9
    (dcn_bwd_weight_tangent) or K10 (dcn_bwd_data_tangent) launch."""
    b, c, h, w = shape
    px, e = b * h * w, torch.finfo(dtype).bits // 8
    x, off, msk, wgt, go = (px * c * e, px * 2 * gd * 9 * e, px * gd * 9 * e,
                            c * c * 9 * e, px * c * e)
    nbytes = x + 2 * off + msk + {"dcn_fwd_tangent": wgt + px * c * e,
                                  "dcn_bwd_weight_tangent": go + wgt,
                                  "dcn_bwd_data_tangent": wgt + go + x + off + msk}[name]
    flops = 2 * px * c * c * 9
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name(dtype)])


def launch_bound(kernel: str, shape, gd: int, dtype) -> float:
    if "tangent" in kernel:
        return tangent_bound(kernel, shape, gd, dtype)
    return dcn_bound(kernel, shape, gd, dtype)


# A kernel's label by a part of its name, first match wins: the port's
# kernels (the tangents before the first-order names they extend), their
# wrappers' helper kernels, then the library's families and kinds.
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

# Each DCN kernel with the helper launches its wrapper makes.
KERNEL_LABELS = {
    "dcn_fwd": ("dcn_fwd", "dcn_fwd helpers"),
    "dcn_bwd_data": ("dcn_bwd_data", "dcn_bwd_data helpers"),
    "dcn_bwd_weight": ("dcn_bwd_weight", "dcn_bwd_weight helpers"),
    "dcn_fwd_tangent": ("dcn_fwd_tangent", "dcn_fwd_tangent helpers"),
    "dcn_bwd_weight_tangent": ("dcn_bwd_weight_tangent", "dcn_bwd_weight_tangent helpers"),
    "dcn_bwd_data_tangent": ("dcn_bwd_data_tangent",),
}


def kernel_label(name: str) -> str:
    low = name.lower()
    for part, label in LABELS:
        if part.lower() in low:
            return label
    return "other"


def roofline_pct(trace, kernels) -> Optional[float]:
    """100 * sum of the least times of the window's launches of `kernels`
    over their device time (helpers included); None without a launch or
    without device time."""
    bound = sum(launch_bound(k, s, gd, dt) for k, s, gd, dt in trace.dcn_calls if k in kernels)
    labels = {lab for k in kernels for lab in KERNEL_LABELS[k]}
    took = sum(e.us for e in trace.device if kernel_label(e.name) in labels) / 1e6
    if bound <= 0 or took <= 0:
        return None
    return 100.0 * bound / took


def mfu_pct(trace) -> Optional[float]:
    """100 * the reference's FLOPs of the window's units over window
    seconds times the configuration's dtype peak."""
    flops = trace.info.get("flops_per_unit", 0) * trace.counters.get("units", 0)
    if flops <= 0 or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * flops / (trace.window_s * PEAK_FLOPS[trace.info["dtype"]])


def power_limit_w() -> Optional[float]:
    """The card's power limit (W), from nvidia-smi; None where it cannot be
    read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20).stdout.split()
        return float(out[0]) if out else None
    except (OSError, ValueError, subprocess.SubprocessError):
        return None
