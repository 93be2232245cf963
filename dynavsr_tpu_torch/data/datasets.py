"""Datasets — copy of dynavsr_tpu/data/datasets.py (the training sets and
the test sets).

REDSDataset: N-frame training windows from REDS-style clips (the REDS4
clips 000 / 011 / 015 / 020 left out of training), a random frame interval
from `interval_list`, `random_reverse`, the window re-centred inside its
clip (and its border frames repeated when the clip is shorter than the
window), a paired random crop and flip / rotate augmentation; the GT is the
centre frame. Vimeo90KDataset: the same over septuplets (flat or nested
layout, optionally restricted by `meta_info_file`). MetaVideoDataset: HR
windows only, for meta-training and downscaler training. VideoTestDataset (Vid4 /
REDS4): whole clips in memory, every frame a centre. Vimeo90KTestDataset
(Vimeo90K-T): one item per septuplet, its centre frame scored.

Clips come from image-folder trees or from LMDB roots (`*.lmdb`,
data/lmdb_dataset.py). Items are numpy float32 RGB in [0, 1], NHWC, frames
stacked on axis 0, as in the JAX package; the loader (data/loader.py)
batches them.
"""

from __future__ import annotations

import bisect
import random
import warnings
from typing import Dict, List, Mapping, Optional

import numpy as np

from dynavsr_tpu_torch.data.io import glob_clip_folders, read_img, read_img_u8, to_float
from dynavsr_tpu_torch.data.windows import index_generation

__all__ = ["REDSDataset", "Vimeo90KDataset", "MetaVideoDataset", "VideoTestDataset",
           "Vimeo90KTestDataset", "augment", "paired_random_crop"]

REDS4_CLIPS = ("000", "011", "015", "020")


def augment(imgs: List[np.ndarray], hflip: bool, vflip: bool, rot90: bool) -> List[np.ndarray]:
    """The same flips and transpose applied to every image."""
    out = []
    for img in imgs:
        if hflip:
            img = img[:, ::-1]
        if vflip:
            img = img[::-1]
        if rot90:
            img = img.transpose(1, 0, 2) if img.ndim == 3 else img.T
        out.append(np.ascontiguousarray(img))
    return out


def paired_random_crop(lqs: np.ndarray, gt: np.ndarray, lq_size: int, scale: int,
                       rng: random.Random) -> tuple:
    """One random crop of an LQ stack (T, h, w, 3) and the matching crop of
    its GT (H, W, 3)."""
    _, h, w, _ = lqs.shape
    top = rng.randint(0, h - lq_size)
    left = rng.randint(0, w - lq_size)
    gt_size = lq_size * scale
    return (lqs[:, top: top + lq_size, left: left + lq_size],
            gt[top * scale: top * scale + gt_size, left * scale: left * scale + gt_size])


class _ClipIndex:
    """Clip discovery and frame reading over a folder tree or an LMDB root."""

    def __init__(self, root: str):
        self._lmdb = None
        if str(root).endswith(".lmdb"):
            from dynavsr_tpu_torch.data.lmdb_dataset import LmdbClipIndex

            self._lmdb = LmdbClipIndex(root)
            self.clips = self._lmdb.clips
        else:
            self.clips = glob_clip_folders(root)
        if not self.clips:
            raise FileNotFoundError(f"no clip folders under {root}")
        self.names = list(self.clips)

    def read(self, clip: str, i: int) -> np.ndarray:
        if self._lmdb is not None:
            return self._lmdb.read_frame(self.clips[clip][i])
        return read_img(self.clips[clip][i])

    def read_u8(self, clip: str, i: int) -> np.ndarray:
        """Frame i as stored (RGB), before `read`'s float conversion."""
        if self._lmdb is not None:
            return self._lmdb.read_frame_u8(self.clips[clip][i])
        return read_img_u8(self.clips[clip][i])

    def read_seq(self, clip: str, idxs) -> np.ndarray:
        return np.stack([self.read(clip, int(i)) for i in idxs], axis=0)


class REDSDataset:
    """Training windows from REDS-style clips. opt keys (the reference's):
    dataroot_GT, dataroot_LQ, N_frames, interval_list, random_reverse,
    LQ_size, use_flip, use_rot, scale, phase."""

    def __init__(self, opt: Mapping):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        self.n_frames = opt.get("N_frames", 5)
        self.interval_list = list(opt.get("interval_list") or [1])
        self.random_reverse = bool(opt.get("random_reverse", False))
        self.lq_size = opt.get("LQ_size", 64)
        self.use_flip = opt.get("use_flip", True) is not False
        self.use_rot = opt.get("use_rot", True) is not False
        self.gt_index = _ClipIndex(opt["dataroot_GT"])
        self.lq_index = _ClipIndex(opt["dataroot_LQ"])
        exclude = REDS4_CLIPS if opt.get("phase", "train") == "train" else ()
        self.names = [n for n in self.gt_index.names if n not in exclude]
        self.lengths = {n: len(self.gt_index.clips[n]) for n in self.names}
        self._warned = False

    def __len__(self) -> int:
        return sum(self.lengths.values())

    def _locate(self, index: int):
        for n in self.names:
            if index < self.lengths[n]:
                return n, index
            index -= self.lengths[n]
        raise IndexError(index)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_item(index)

    def get_item(self, index: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        """The item at `index` with its interval, reversal, crop and flips
        drawn from `rng`. The loader passes an rng made from (seed, epoch,
        stream position), so a resumed run draws exactly what it would have.
        Without one (direct ds[i]) the rng is a function of the index alone
        and the augmentation repeats every epoch: fine for tests, warned."""
        if rng is None:
            if not self._warned:
                self._warned = True
                warnings.warn("REDSDataset accessed directly (ds[i]) without a loader rng: "
                              "augmentation is index-only (epoch-invariant). Fine for tests; "
                              "use the loader for training.", stacklevel=2)
            rng = random.Random(index)
        clip, center = self._locate(index)
        t = self.lengths[clip]
        interval = rng.choice(self.interval_list)
        half = self.n_frames // 2
        lo, hi = half * interval, t - 1 - half * interval
        if hi >= lo:
            center = min(max(center, lo), hi)
        idxs = list(range(center - half * interval, center + half * interval + 1, interval))
        idxs = [min(max(i, 0), t - 1) for i in idxs]
        if self.random_reverse and rng.random() < 0.5:
            idxs.reverse()
        lqs = self.lq_index.read_seq(clip, idxs)
        gt = self.gt_index.read(clip, idxs[len(idxs) // 2])
        lqs, gt = paired_random_crop(lqs, gt, self.lq_size, self.scale, rng)
        hflip = self.use_flip and rng.random() < 0.5
        vflip = self.use_rot and rng.random() < 0.5
        rot = self.use_rot and rng.random() < 0.5
        frames = augment(list(lqs) + [gt], hflip, vflip, rot)
        return {"LQs": np.stack(frames[:-1], axis=0), "GT": frames[-1],
                "key": f"{clip}_{idxs[len(idxs) // 2]:08d}"}


class Vimeo90KDataset(REDSDataset):
    """Vimeo90K septuplets through the same pipeline, no clip left out.
    Nested clips (sequences/00001/0266/im*.png) are keyed '00001_0266'; a
    `meta_info_file` (one '00001/0266' a line, the reference's
    sep_trainlist.txt) restricts training to the septuplets it lists."""

    def __init__(self, opt: Mapping):
        opt = dict(opt)
        opt.setdefault("N_frames", 7)
        super().__init__(opt)
        self.names = self.gt_index.names
        meta = opt.get("meta_info_file")
        if meta:
            with open(meta) as f:
                keep = {line.strip().replace("/", "_") for line in f if line.strip()}
            self.names = [n for n in self.names if n in keep]
            if not self.names:
                raise FileNotFoundError(f"no clips from {meta} found under {opt['dataroot_GT']}")
        self.lengths = {n: len(self.gt_index.clips[n]) for n in self.names}


class MetaVideoDataset:
    """Meta-training and downscaler-training items: HR windows only (the
    `meta` dataset modes); LR / SLR are synthesised on the device from them
    (data/degradations.synthesize_pair). opt keys: dataroot_GT (folders or
    an LMDB root), N_frames, GT_size, scale.

    Item i is the temporal window at position i of the cumulative windows
    of every clip, so one epoch visits each window exactly once; the rng
    draws only the spatial crop. Frames are cropped as read (uint8) and
    converted to float after: the same floats as cropping the float frames,
    for a fraction of the conversion."""

    def __init__(self, opt: Mapping):
        self.opt = opt
        self.scale = opt.get("scale", 4)
        self.n_frames = opt.get("N_frames", 5)
        self.hr_size = opt.get("GT_size", 128)
        self.index = _ClipIndex(opt["dataroot_GT"])
        self.names = self.index.names
        self.lengths = {n: len(self.index.clips[n]) for n in self.names}
        # Cumulative window counts: index -> (clip, first frame).
        self._bounds, self._spans = [], []
        base = 0
        for n in self.names:
            self._spans.append((n, base))
            base += max(1, self.lengths[n] - self.n_frames + 1)
            self._bounds.append(base)

    def __len__(self) -> int:
        return self._bounds[-1] if self._bounds else 0

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.get_item(index)

    def get_item(self, index: int, rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        """The window at `index` (mod len), cropped to GT_size at a position
        drawn from `rng` (random.Random(index) when none is given)."""
        if rng is None:
            rng = random.Random(index)
        j = index % len(self)
        clip, base = self._spans[bisect.bisect_right(self._bounds, j)]
        start = j - base
        t = self.lengths[clip]
        frames = [self.index.read_u8(clip, min(start + i, t - 1)) for i in range(self.n_frames)]
        h, w = frames[0].shape[:2]
        s = self.hr_size
        top = rng.randint(0, max(0, h - s))
        left = rng.randint(0, max(0, w - s))
        hr = np.stack([to_float(f[top: top + s, left: left + s]) for f in frames], axis=0)
        return {"HR": hr, "key": f"{clip}_{start:08d}"}


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
