"""Frame IO — copy of dynavsr_tpu/data/io.py (image folders).

`read_img` returns float32 RGB in [0, 1]; `read_img_seq` stacks a clip;
`get_image_paths` lists an image tree ('img') or an LMDB's keys ('lmdb',
through data/lmdb_native.py). cv2 is imported inside the function that
reads a file, so the package imports on a host without it. LMDB roots are
read by data/lmdb_dataset.py.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List

import numpy as np

__all__ = ["read_img", "read_img_u8", "read_img_seq", "to_float", "get_image_paths",
           "glob_clip_folders"]

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")


def read_img(path: str) -> np.ndarray:
    """Read one image -> float32 RGB HWC in [0, 1]."""
    return to_float(read_img_u8(path))


def to_float(img: np.ndarray) -> np.ndarray:
    """A frame as read (RGB HWC, integer) -> float32 in [0, 1]. Elementwise,
    so cropping before it gives the same floats as cropping after."""
    return np.ascontiguousarray(img).astype(np.float32) / 255.0


def read_img_u8(path: str) -> np.ndarray:
    """Read one image -> RGB HWC as stored (uint8 for 8-bit files), before
    the float conversion of `read_img`."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def read_img_seq(paths: List[str]) -> np.ndarray:
    """Stack a clip's frames -> (T, H, W, 3) float32 RGB."""
    return np.stack([read_img(p) for p in paths], axis=0)


def get_image_paths(data_type: str, dataroot: str) -> List[str]:
    """Sorted frame paths under a folder tree ('img') or an LMDB's keys
    without the '.meta' entries ('lmdb')."""
    if data_type == "img":
        return sorted(osp.join(root, f) for root, _dirs, files in os.walk(dataroot)
                      for f in files if f.lower().endswith(_IMG_EXTS))
    if data_type == "lmdb":
        from dynavsr_tpu_torch.data.lmdb_native import LmdbReader

        with LmdbReader(dataroot) as r:
            return sorted(k.decode() for k in r.keys() if not k.endswith(b".meta"))
    raise ValueError(f"unknown data_type {data_type!r}")


def glob_clip_folders(dataroot: str) -> Dict[str, List[str]]:
    """Map clip name -> sorted frame paths; a clip is any directory under
    dataroot that directly contains image files (nested clips are keyed by
    their relative path with '_' separators). A dataroot that holds frames
    and no clip subdirectories is one clip named 'clip'."""
    clips: Dict[str, List[str]] = {}
    root_frames: List[str] = []
    for root, dirs, files in os.walk(dataroot):
        dirs.sort()
        frames = sorted(
            osp.join(root, f) for f in files if f.lower().endswith(_IMG_EXTS)
        )
        if not frames:
            continue
        rel = osp.relpath(root, dataroot)
        if rel == ".":
            root_frames = frames
            continue
        clips[rel.replace(os.sep, "_")] = frames
    if root_frames and not clips:
        clips["clip"] = root_frames
    return dict(sorted(clips.items()))
