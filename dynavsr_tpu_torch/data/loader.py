"""Dataset factory for the test sets (port of the test half of
dynavsr_tpu/data/loader.py:create_dataset).

String dispatch on a dataset block's `mode`, as the JAX package does. The
training modes wait for the port's trainer (ROADMAP A.3).
"""

from __future__ import annotations

from typing import Mapping

from dynavsr_tpu_torch.data.datasets import VideoTestDataset, Vimeo90KTestDataset

__all__ = ["create_dataset"]

_VIDEO_TEST = ("video_test", "video_samedirs", "Vid4", "REDS4")
_VIMEO_TEST = ("Vimeo90K_test", "vimeo90k_test")
_TRAINING = ("REDS", "Vimeo90K", "meta", "meta_learner", "MetaREDS", "MetaVimeo")


def create_dataset(dataset_opt: Mapping):
    mode = dataset_opt["mode"]
    if mode in _VIDEO_TEST:
        return VideoTestDataset(dataset_opt)
    if mode in _VIMEO_TEST:
        return Vimeo90KTestDataset(dataset_opt)
    if mode in _TRAINING:
        raise NotImplementedError(
            f"dataset mode {mode!r} is a training set; those come with the port's trainer "
            "(ROADMAP A.3)")
    raise NotImplementedError(f"Dataset [{mode}] is not recognized.")
