"""Whole-clip eval set — copy of dynavsr_tpu/data/datasets.py:VideoTestDataset
(image-folder roots only; the LMDB index and the training datasets are
not ported yet)."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from dynavsr_tpu_torch.data.io import glob_clip_folders, read_img

__all__ = ["VideoTestDataset"]


class _ClipIndex:
    def __init__(self, root: str):
        if str(root).endswith(".lmdb"):
            raise NotImplementedError(
                "LMDB roots are not ported yet (ROADMAP: LMDB reader)")
        self.clips = glob_clip_folders(root)
        if not self.clips:
            raise FileNotFoundError(f"no clip folders under {root}")
        self.names = list(self.clips)

    def read_seq(self, clip: str, idxs) -> np.ndarray:
        return np.stack([read_img(self.clips[clip][int(i)]) for i in idxs], axis=0)


class VideoTestDataset:
    """Vid4 / REDS4-style eval set: whole clips read into memory."""

    def __init__(self, opt: Mapping):
        self.cache_data = opt.get("cache_data", True) is not False
        gt_root = opt.get("dataroot_GT")
        self.lq_index = _ClipIndex(opt["dataroot_LQ"])
        self.gt_index = _ClipIndex(gt_root) if gt_root else None
        self.names = self.lq_index.names
        self._cache: Dict[str, np.ndarray] = {}

    def clip_frames(self, clip: str, gt: bool = False) -> np.ndarray:
        index = self.gt_index if gt else self.lq_index
        key = ("gt:" if gt else "lq:") + clip
        if key not in self._cache:
            arr = index.read_seq(clip, range(len(index.clips[clip])))
            if not self.cache_data:
                return arr
            self._cache[key] = arr
        return self._cache[key]
