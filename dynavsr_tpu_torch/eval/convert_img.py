"""Array -> displayable image conversion (reference utils/util.py:tensor2img [H]).

Our tensors are NHWC float in [0, 1]; the reference's were NCHW torch. The
contract preserved: clamp to [0, 1], scale by 255, round, uint8. Channel
order is kept RGB internally; writers flip to BGR only if asked (the
reference stored BGR because it used cv2 for IO — we use imageio/PIL which
are RGB, so PNG files on disk are byte-identical either way).
"""

from __future__ import annotations

import numpy as np

__all__ = ["tensor2img", "save_img"]


def tensor2img(x, min_max=(0.0, 1.0)) -> np.ndarray:
    """(H, W, C) or (H, W) float array in min_max -> uint8 HWC image."""
    a = np.asarray(x, dtype=np.float64)
    a = (a - min_max[0]) / (min_max[1] - min_max[0])
    a = np.clip(a, 0.0, 1.0)
    return (a * 255.0).round().astype(np.uint8)


def save_img(img: np.ndarray, path: str) -> None:
    import imageio.v2 as imageio

    imageio.imwrite(path, img)
