"""MATLAB-compatible bicubic resize as two matmuls (port of
dynavsr_tpu/data/resize.py).

`resize_weights` is a copy of the JAX package's numpy function (cubic
kernel a=-0.5, antialiasing when downscaling, symmetric boundary fold).
`imresize` applies it as out = W_h @ img @ W_w.T per channel, in fp32 at
full precision: this op defines dataset parity, so TF32 must be off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_weights", "imresize"]


def _cubic(x: np.ndarray) -> np.ndarray:
    """Keys cubic convolution kernel with a = -0.5 (MATLAB's 'cubic')."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    inner = 1.5 * ax3 - 2.5 * ax2 + 1.0
    outer = -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    return np.where(ax <= 1.0, inner, np.where(ax <= 2.0, outer, 0.0))


@functools.lru_cache(maxsize=256)
def resize_weights(in_len: int, out_len: int, antialias: bool = True) -> np.ndarray:
    """Dense (out_len, in_len) float64 interpolation matrix, one axis
    (MATLAB imresize's `contributions`, rows normalised, out-of-range taps
    folded back by mirror indexing)."""
    scale = out_len / in_len
    kernel_width = 4.0
    downscale_aa = antialias and scale < 1.0
    if downscale_aa:
        kernel_width /= scale

    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1.0 - 1.0 / scale)
    left = np.floor(u - kernel_width / 2.0)
    p = int(np.ceil(kernel_width)) + 2
    ind = left[:, None] + np.arange(p, dtype=np.float64)[None, :]  # 1-based
    dist = u[:, None] - ind
    if downscale_aa:
        w = scale * _cubic(dist * scale)
    else:
        w = _cubic(dist)
    w = w / w.sum(axis=1, keepdims=True)

    idx0 = ind.astype(np.int64) - 1
    aux = np.concatenate([np.arange(in_len), np.arange(in_len - 1, -1, -1)])
    idx = aux[np.mod(idx0, 2 * in_len)]

    mat = np.zeros((out_len, in_len), dtype=np.float64)
    rows = np.repeat(np.arange(out_len), p)
    np.add.at(mat, (rows, idx.ravel()), w.ravel())
    return mat


def _out_len(in_len: int, scale: float) -> int:
    return int(np.ceil(in_len * scale))


@functools.lru_cache(maxsize=64)
def _device_weights(in_len: int, out_len: int, antialiasing: bool,
                    device: torch.device) -> torch.Tensor:
    """resize_weights as an fp32 tensor on `device`, copied there once: a
    copy from pageable host memory would wait for the device's queue to
    drain at every call."""
    return torch.as_tensor(resize_weights(in_len, out_len, antialiasing),
                           dtype=torch.float32, device=device)


def imresize(img: torch.Tensor, scale: float, antialiasing: bool = True) -> torch.Tensor:
    """MATLAB-parity bicubic resize of a (..., H, W, C) tensor, in fp32."""
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("imresize needs full fp32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    h, w = img.shape[-3], img.shape[-2]
    oh, ow = _out_len(h, scale), _out_len(w, scale)
    wh = _device_weights(h, oh, antialiasing, img.device)
    ww = _device_weights(w, ow, antialiasing, img.device)
    x = img.to(torch.float32).movedim(-1, -3)  # (..., C, H, W)
    x = torch.matmul(torch.matmul(wh, x), ww.t())
    x = x.movedim(-3, -1)
    return x.to(img.dtype) if img.is_floating_point() else x
