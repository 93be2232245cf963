"""Color-space conversions, bit-compatible with the reference's data/util.py.

Parity matters: Vid4/Vimeo PSNR is reported on the Y channel produced by
exactly these ITU-R BT.601 "TV range" coefficients, including the uint8
round-trip rounding (SURVEY.md §2.4, §5 — data/util.py:bgr2ycbcr [H]).
"""

from __future__ import annotations

import numpy as np

__all__ = ["bgr2ycbcr", "rgb2ycbcr", "ycbcr2rgb", "channel_convert"]

# Columns: Y, Cb, Cr. Rows are (B, G, R) for the BGR matrix.
_BGR2YCBCR = np.array(
    [
        [24.966, 112.0, -18.214],
        [128.553, -74.203, -93.786],
        [65.481, -37.797, 112.0],
    ],
    dtype=np.float64,
)
_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)


def _to_ycbcr(img: np.ndarray, mat: np.ndarray, only_y: bool) -> np.ndarray:
    in_dtype = img.dtype
    x = img.astype(np.float64)
    if in_dtype != np.uint8:
        x = x * 255.0
    if only_y:
        out = x @ mat[:, 0] / 255.0 + _OFFSET[0]
    else:
        out = x @ mat / 255.0 + _OFFSET
    if in_dtype == np.uint8:
        out = out.round()
    else:
        out = out / 255.0
    return out.astype(in_dtype)


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """BGR (HWC) -> YCbCr (or Y only). uint8 in [16,235] / float in [0,1]."""
    return _to_ycbcr(img, _BGR2YCBCR, only_y)


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """RGB (HWC) -> YCbCr (or Y only)."""
    return _to_ycbcr(img, _BGR2YCBCR[::-1].copy(), only_y)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    """YCbCr -> RGB, inverse of rgb2ycbcr (float or uint8, TV range)."""
    in_dtype = img.dtype
    x = img.astype(np.float64)
    if in_dtype != np.uint8:
        x = x * 255.0
    mat = _BGR2YCBCR[::-1] / 255.0  # rows RGB -> cols YCbCr
    inv = np.linalg.inv(mat)
    out = (x - _OFFSET) @ inv
    if in_dtype == np.uint8:
        out = out.round().clip(0, 255)
    else:
        out = out / 255.0
    return out.astype(in_dtype)


def channel_convert(in_c: int, tar_type: str, img_list):
    """Reference data/util.py:channel_convert semantics [H]: convert a list
    of HWC images between color spaces ('gray', 'y', 'RGB')."""
    if in_c == 3 and tar_type == "gray":
        return [np.expand_dims(rgb2ycbcr(im, only_y=True), 2) for im in img_list]
    if in_c == 3 and tar_type == "y":
        return [np.expand_dims(bgr2ycbcr(im, only_y=True), 2) for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(im, 3, axis=2) for im in img_list]
    return img_list
