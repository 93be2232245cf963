"""Temporal sliding-window index generation with border padding.

Parity target: data/util.py:index_generation in the reference (SURVEY.md
§2.4 [H]) — given the center frame index of an N-frame window inside a clip
of max_n frames, return the N neighbor indices, padding at clip borders by
one of: replicate, reflection, reflection_circle, circle, new_info.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["index_generation", "all_windows"]

_PADDINGS = ("replicate", "reflection", "reflection_circle", "circle", "new_info")


def index_generation(crt_i: int, max_n: int, n_frames: int, padding: str = "reflection") -> List[int]:
    """Neighbor indices for the window centered at crt_i.

    crt_i: center frame index (0-based). max_n: number of frames in the clip.
    n_frames: window size (odd). padding: border strategy.
    """
    if padding not in _PADDINGS:
        raise ValueError(f"padding must be one of {_PADDINGS}, got {padding!r}")
    last = max_n - 1
    n_pad = n_frames // 2
    out: List[int] = []
    for i in range(crt_i - n_pad, crt_i + n_pad + 1):
        if i < 0:
            if padding == "replicate":
                idx = 0
            elif padding == "reflection":
                idx = -i
            elif padding == "reflection_circle":
                idx = crt_i + n_pad - i
            elif padding == "circle":
                idx = n_frames + i
            else:  # new_info: borrow "future" frames past the window
                idx = (crt_i + n_pad) + (-i)
        elif i > last:
            if padding == "replicate":
                idx = last
            elif padding == "reflection":
                idx = last * 2 - i
            elif padding == "reflection_circle":
                idx = (crt_i - n_pad) - (i - last)
            elif padding == "circle":
                idx = i - n_frames
            else:  # new_info
                idx = (crt_i - n_pad) - (i - last)
        else:
            idx = i
        out.append(idx)
    return out


def all_windows(max_n: int, n_frames: int, padding: str = "reflection") -> np.ndarray:
    """(max_n, n_frames) int array: window indices for every center frame.

    Used to batch a whole clip's sliding windows in one device array —
    the TPU-native replacement for the reference's per-frame Python loop.
    """
    return np.asarray(
        [index_generation(i, max_n, n_frames, padding) for i in range(max_n)],
        dtype=np.int32,
    )
