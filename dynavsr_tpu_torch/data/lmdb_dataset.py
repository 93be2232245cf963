"""LMDB-backed clip index for the datasets (port of
dynavsr_tpu/data/lmdb_dataset.py).

Layout: key '<clip>_<frame:08d>' -> an encoded image (PNG / JPEG / BMP /
TIFF, as data_scripts/create_lmdb.py stores the frame files) or raw uint8
BGR bytes, whose '<key>.meta' entry holds 'HxWxC'. The card's machine has
no OpenCV, so a raw entry is read without it: an entry is raw when it has a
.meta entry whose H*W*C is its length, and is otherwise decoded with
cv2.imdecode (cv2 imported inside the function, as data/io.py does). The
JAX package decodes first and falls back to the .meta shape; the two read
every entry either can read the same way.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from dynavsr_tpu_torch.data.io import to_float
from dynavsr_tpu_torch.data.lmdb_native import LmdbReader

__all__ = ["LmdbClipIndex"]

_SIGNATURES = (b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff", b"BM", b"II*\x00", b"MM\x00*")


class LmdbClipIndex:
    """Maps clip -> its frame keys (sorted); read_frame returns float32 RGB
    in [0, 1], grey frames repeated to 3 channels (read_frame_u8 the same
    frame before the float conversion)."""

    def __init__(self, path: str):
        self.reader = LmdbReader(path)
        self.clips: Dict[str, List[bytes]] = {}
        for key in self.reader.keys():
            name = key.decode()
            if name.endswith(".meta"):
                continue
            clip, _, _frame = name.rpartition("_")
            self.clips.setdefault(clip, []).append(key)
        for frames in self.clips.values():
            frames.sort()
        self.names = sorted(self.clips)

    def read_frame(self, key: bytes) -> np.ndarray:
        return to_float(self.read_frame_u8(key))

    def read_frame_u8(self, key: bytes) -> np.ndarray:
        """The frame as stored, RGB (a view of the entry where it is raw),
        before read_frame's float conversion."""
        buf = self.reader.get(key)
        if buf is None:
            raise KeyError(key)
        meta = self.reader.get(key + b".meta")
        shape = tuple(int(x) for x in meta.decode().split("x")) if meta is not None else None
        if shape is not None and int(np.prod(shape)) == len(buf):
            img = np.frombuffer(buf, np.uint8).reshape(shape)
        elif buf.startswith(_SIGNATURES):
            import cv2

            img = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError(f"undecodable image entry {key!r}")
        else:
            raise ValueError(f"entry {key!r} is neither an encoded image nor raw bytes "
                             "with a matching .meta")
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = img.repeat(3, axis=2)
        return img[:, :, 2::-1]
