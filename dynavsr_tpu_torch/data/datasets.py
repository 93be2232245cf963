"""Test sets over image folders — copy of dynavsr_tpu/data/datasets.py's
VideoTestDataset and Vimeo90KTestDataset.

VideoTestDataset (Vid4 / REDS4): whole clips in memory, every frame a
centre, one item per frame. Vimeo90KTestDataset (Vimeo90K-T): one item per
septuplet, only its centre frame super-resolved and scored. The LMDB index
and the training datasets wait for the port's trainer (ROADMAP A.3).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from dynavsr_tpu_torch.data.io import glob_clip_folders, read_img
from dynavsr_tpu_torch.data.windows import index_generation

__all__ = ["VideoTestDataset", "Vimeo90KTestDataset"]


class _ClipIndex:
    def __init__(self, root: str):
        if str(root).endswith(".lmdb"):
            raise NotImplementedError(
                f"{root}: LMDB roots are not ported yet; no test config reads one, and the "
                "training datasets that do come with the port's trainer (ROADMAP A.3)")
        self.clips = glob_clip_folders(root)
        if not self.clips:
            raise FileNotFoundError(f"no clip folders under {root}")
        self.names = list(self.clips)

    def read_seq(self, clip: str, idxs) -> np.ndarray:
        return np.stack([read_img(self.clips[clip][int(i)]) for i in idxs], axis=0)


class VideoTestDataset:
    """Vid4 / REDS4-style eval set: whole clips read into memory; one item
    per frame, its window of `N_frames` indices padded at the clip's ends
    by `padding` (data/windows.index_generation)."""

    center_only = False

    def __init__(self, opt: Mapping):
        self.n_frames = opt.get("N_frames", 5)
        self.padding = opt.get("padding", "reflection")
        self.cache_data = opt.get("cache_data", True) is not False
        gt_root = opt.get("dataroot_GT")
        self.lq_index = _ClipIndex(opt["dataroot_LQ"])
        self.gt_index = _ClipIndex(gt_root) if gt_root else None
        self.names = self.lq_index.names
        self._cache: Dict[str, np.ndarray] = {}
        self.items = [(clip, i, t) for clip in self.names
                      for t in [len(self.lq_index.clips[clip])] for i in range(t)]

    def has_gt(self, clip: str) -> bool:
        """Whether the clip has GT frames (a clip without is not scored)."""
        return self.gt_index is not None and clip in self.gt_index.clips

    def clip_frames(self, clip: str, gt: bool = False) -> np.ndarray:
        index = self.gt_index if gt else self.lq_index
        key = ("gt:" if gt else "lq:") + clip
        if key not in self._cache:
            arr = index.read_seq(clip, range(len(index.clips[clip])))
            if not self.cache_data:
                return arr
            self._cache[key] = arr
        return self._cache[key]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> Dict:
        clip, i, t = self.items[index]
        sel = index_generation(i, t, self.n_frames, self.padding)
        item = {
            "LQs": self.clip_frames(clip)[sel],
            "folder": clip,
            "idx": f"{i}/{t}",
            "border": self._border(i, t),
        }
        if self.has_gt(clip):
            item["GT"] = self.clip_frames(clip, gt=True)[i]
        return item

    def _border(self, i: int, t: int) -> int:
        return int(i < self.n_frames // 2 or i >= t - self.n_frames // 2)


class Vimeo90KTestDataset(VideoTestDataset):
    """Vimeo90K-T protocol: each septuplet directory is one item, and only
    its centre frame is super-resolved and scored."""

    center_only = True

    def __init__(self, opt: Mapping):
        super().__init__(opt)
        self.items = [(clip, t // 2, t) for clip in self.names
                      for t in [len(self.lq_index.clips[clip])]]

    def _border(self, i: int, t: int) -> int:
        return 0
