"""Plain evaluation without adaptation (port of dynavsr_tpu/cli/test.py).

Builds the config's net (models/video_base_model.create_model), and for
each dataset block (data/loader.create_dataset: Vid4 / REDS4 whole clips,
or Vimeo90K-T's centre frames) super-resolves every frame's window and
scores it. `eval.seq: true` runs EDVR in sequence mode; `eval.infer_chunk`
(default 8) bounds the windows a forward takes; `eval.tile` (an int or
[th, tw]) with `eval.tile_overlap` (default 32) runs each forward as
overlapping spatial tiles (eval/tiled.py).

    python -m dynavsr_tpu_torch.cli.test -opt configs/test/test_EDVR_M_REDS4.yml
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp

from dynavsr_tpu_torch.data.loader import create_dataset
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import evaluate_dataset
from dynavsr_tpu_torch.models.video_base_model import create_model

__all__ = ["main", "run"]

logger = logging.getLogger("dynavsr_tpu_torch")


def main(argv=None) -> dict:
    """{dataset block name: {clip: scores, '_avg': ...}}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--no-save-images", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda")
    args = parser.parse_args(argv)

    from dynavsr_tpu_torch.config.options import parse

    device = resolve_device(args.device)
    return run(parse(args.opt), device, args.no_save_images)


def run(opt, device, no_save_images: bool) -> dict:
    """`main` on a derived config (config/options.parse, or derive on a
    dict) and a resolved device: {dataset block name: {clip: scores,
    '_avg': ...}}."""
    from dynavsr_tpu_torch.config.options import dict2str

    logging.basicConfig(level=logging.INFO)
    logger.info(dict2str(opt))
    model = create_model(opt, device)
    ev = opt.get("eval") or {}
    seq_fn = model.make_seq_infer_fn() if ev.get("seq") else None
    if ev.get("seq") and seq_fn is None:
        logger.warning("eval.seq requested but %s has no pyramid-split forward, or eval.tile "
                       "is set: using the window-batched path.", model.netG.arch)
    all_results = {}
    for name, dataset_opt in (opt["datasets"] or {}).items():
        test_set = create_dataset(dataset_opt)
        label = dataset_opt.get("name") or name
        logger.info("Testing [%s] (%d clips)...", label, len(test_set.names))
        all_results[name] = evaluate_dataset(
            model.make_infer_fn(), test_set,
            n_frames=dataset_opt.get("N_frames") or 5,
            padding=dataset_opt.get("padding") or "reflection",
            chunk=model.infer_chunk,
            ycbcr=bool(ev.get("ycbcr", False)),
            crop_border=int(ev.get("crop_border") or 0),
            save_root=None if no_save_images else osp.join(
                opt["path"]["results_root"], label),
            logger=logger, seq_fn=seq_fn)
    return all_results


if __name__ == "__main__":
    main()
