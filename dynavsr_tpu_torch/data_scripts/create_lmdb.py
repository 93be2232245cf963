"""Build an LMDB from a clip-folder tree (port of the repo's
data_scripts/create_lmdb.py), with the port's native writer
(data/lmdb_native.LmdbWriter).

    python -m dynavsr_tpu_torch.data_scripts.create_lmdb \
        --input ~/datasets/REDS/train_sharp --output ~/datasets/REDS/train_sharp_wval.lmdb

Keys follow the reference convention '<clip>_<frame:08d>'; values are the
original encoded bytes (PNG / JPG passed through, not re-encoded). No
tensor work: the script needs no device.
"""

from __future__ import annotations

import argparse

from dynavsr_tpu_torch.data.io import glob_clip_folders
from dynavsr_tpu_torch.data.lmdb_native import LmdbWriter
from dynavsr_tpu_torch.utils.util import ProgressBar

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", required=True, help="clip-folder tree root")
    ap.add_argument("--output", required=True, help="output .lmdb path")
    args = ap.parse_args(argv)

    clips = glob_clip_folders(args.input)
    total = sum(len(v) for v in clips.values())
    print(f"{len(clips)} clips, {total} frames -> {args.output}")
    bar = ProgressBar(total)
    with LmdbWriter(args.output) as w:
        for clip, frames in clips.items():
            for i, path in enumerate(frames):
                with open(path, "rb") as f:
                    w.put(f"{clip}_{i:08d}".encode(), f.read())
                bar.update(f"{clip}/{i}")
    print("\ndone.")


if __name__ == "__main__":
    main()
