"""Training entry point (port of dynavsr_tpu/cli/train.py): supervised VSR
training, downscaler training and DynaVSR meta-training, by `model`.

    python -m dynavsr_tpu_torch.cli.train -opt configs/train/train_EDVR_M_REDS.yml [--device cpu]
    python -m dynavsr_tpu_torch.cli.train_downscaler -opt configs/train/train_MFDN_Vimeo90K.yml
    python -m dynavsr_tpu_torch.cli.train_dynavsr -opt configs/train/train_DynaVSR_EDVR_REDS.yml

Trains `network_G` on the config's training set (image folders or LMDB
roots) on the card unless `--device cpu` is given:
- `video_base`: REDS / Vimeo90K windows and their GT, the config's pixel
  loss, Adam and lr schedule;
- `downscaler` (MFDN / SFDN): HR windows of a `meta` set, from which each
  step synthesises LR = (HR * k) ds and SLR = (LR * k) ds with one random
  blur kernel per clip (data/degradations.synthesize_pair); the net learns
  LR -> SLR;
- `video_meta`: the same (LR, SLR) pairs, or SLR = network_E(LR) with a
  frozen estimator (`network_E`, weights from `path.pretrain_model_E`),
  and one meta step a batch (train/meta.py).
Each step's degradations come from a generator seeded by (manual_seed,
iteration), so a resumed run draws what the uninterrupted run drew. (The
JAX CLI makes its key after the resume and splits it once a step, so a
resumed run replays the degradations of steps 1, 2, ...)

Every `logger.save_checkpoint_freq` iterations, and at the end, it writes
`<experiments>/<name>/models/<iter>_G.pth` and
`training_state/<iter>.state`; `path.resume_state: .../<iter>.state`
resumes from them on exactly the batches the run would have seen next.
Scalars go to `<root>/tb_logger/<name>/metrics.jsonl`.

Data-parallel training runs one process a card under torchrun with
`--launcher pytorch` (the reference's name; `none`, the default, is one
process, and anything else raises):

    python -m torch.distributed.run --nproc_per_node 4 -m dynavsr_tpu_torch.cli.train \
        -opt configs/train/train_EDVR_M_REDS.yml --launcher pytorch
    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dynavsr_tpu_torch.cli.train -opt ... --launcher pytorch --device cpu   # gloo

`datasets.train.batch_size` is the global batch (parallel/mesh.py; it must
divide by the world size): each rank loads its share, degrades its rows as
the global draw would, and the step all-reduces the gradients, so the W-rank
run trains the one-process run's function. Rank 0 alone archives and makes
the experiment directories, logs to file and screen, writes metrics,
validates and saves; the other ranks wait at barriers. A resume loads on
every rank.
"""

from __future__ import annotations

import argparse
import logging
import math
import os.path as osp
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dynavsr_tpu_torch.config.options import dict2str
from dynavsr_tpu_torch.data.degradations import synthesize_pair
from dynavsr_tpu_torch.data.loader import create_dataloader, create_dataset
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import evaluate_dataset
from dynavsr_tpu_torch.cli.test_dynavsr import build_estimator
from dynavsr_tpu_torch.models.video_base_model import create_model
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.checkpoint import load_pretrained
from dynavsr_tpu_torch.utils.observability import MetricsWriter
from dynavsr_tpu_torch.utils.util import mkdir_and_rename, mkdirs, set_random_seed, setup_logger

__all__ = ["main", "train", "synthesize_meta_batch", "synthesize_downscaler_batch",
           "noise_range", "step_generator", "build_frozen_estimator"]

_DOWNSCALER = ("downscaler", "estimator")
_META = ("video_meta", "meta", "dynavsr")


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of iteration `step`'s degradations, a function of
    (seed, step) only."""
    state = int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def synthesize_meta_batch(gen: torch.Generator, hr, scale: int,
                          estimator: Optional[Callable] = None,
                          noise_range: Tuple[float, float] = (0.0, 0.0),
                          share: Optional[Tuple[int, int]] = None) -> Dict[str, torch.Tensor]:
    """(SLR, LR, centres) from HR windows (B, N, H, W, 3), on gen's
    device. With an estimator, SLR = estimator(LR) (DynaVSR's
    estimator-in-the-loop training) instead of the same-kernel synthesis.
    share = (first row, global batch) for a rank's rows of a global batch
    (data/degradations.synthesize_pair)."""
    hr = torch.as_tensor(hr, dtype=torch.float32, device=gen.device)
    lr, slr, _ = synthesize_pair(gen, hr, scale, noise_range=noise_range, share=share)
    if estimator is not None:
        slr = estimator(lr)
    c = hr.shape[1] // 2
    return {"SLR": slr, "LR": lr, "LR_center": lr[:, c], "HR_center": hr[:, c]}


def synthesize_downscaler_batch(gen: torch.Generator, hr, scale: int,
                                noise_range: Tuple[float, float] = (0.0, 0.0),
                                share: Optional[Tuple[int, int]] = None
                                ) -> Dict[str, torch.Tensor]:
    """{LR, SLR} from HR windows (B, N, H, W, 3), on gen's device; `share`
    as synthesize_meta_batch's."""
    hr = torch.as_tensor(hr, dtype=torch.float32, device=gen.device)
    lr, slr, _ = synthesize_pair(gen, hr, scale, noise_range=noise_range, share=share)
    return {"LR": lr, "SLR": slr}


def noise_range(opt: Mapping) -> Tuple[float, float]:
    """datasets.train.noise_range (the JAX package's read-noise extension),
    (0, 0) when absent."""
    nr = ((opt.get("datasets") or {}).get("train") or {}).get("noise_range") or (0.0, 0.0)
    return float(nr[0]), float(nr[1])


def build_frozen_estimator(opt: Mapping, device) -> Optional[Callable]:
    """network_E (MFDN on the training windows' N_frames, or SFDN) built
    by define_G, loaded from path.pretrain_model_E when set, run in eval
    mode under torch.no_grad; None without network_E."""
    if not opt.get("network_E"):
        return None
    frames = ((opt.get("datasets") or {}).get("train") or {}).get("N_frames") or 5
    est = build_estimator(opt["network_E"], opt.get("scale", 4), frames, device)
    load_pretrained(est, (opt.get("path") or {}).get("pretrain_model_E"))
    est.requires_grad_(False)

    def estimator(lr: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return est(lr)

    return estimator


def main(argv=None) -> int:
    """Parse the arguments and the YAML, then train; returns the last
    iteration."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True, help="Path to YAML config.")
    parser.add_argument("--launcher", default="none",
                        help="none (one process) or pytorch (torchrun, one process a card)")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--max-iters", type=int, default=None,
                        help="Override train.niter (smoke tests).")
    args = parser.parse_args(argv)
    from dynavsr_tpu_torch.config.options import parse

    device = mesh.init_dist(args.launcher, args.device)
    try:
        return train(parse(args.opt, is_train=True), device=device, max_iters=args.max_iters)
    finally:
        if args.launcher != "none":
            torch.distributed.destroy_process_group()


def train(opt: Mapping, device=None, max_iters: Optional[int] = None) -> int:
    """The training loop over a derived config (config/options.parse or
    derive with is_train=True); returns the last iteration."""
    device = resolve_device(device)
    which = opt.get("model") or "video_base"
    paths = opt["path"]
    primary = mesh.is_primary()
    if primary:
        # The experiment directory is archived only for a fresh run: a
        # resuming run keeps the one that holds the state it loads.
        if not paths.get("resume_state"):
            mkdir_and_rename(paths["experiments_root"])
        mkdirs([paths["models"], paths["training_state"], paths["val_images"]])
    mesh.barrier()
    logger = setup_logger("base", paths["log"], "train", screen=primary, tofile=primary)
    logger.info(dict2str(opt))
    seed = opt["train"].get("manual_seed") or 0
    set_random_seed(seed)
    tb = None
    if primary and (opt.get("logger") or {}).get("tb_logger", True) is not False:
        tb = MetricsWriter(osp.join(paths["root"], "tb_logger", opt.get("name") or "run"))

    train_loader = val_set = None
    for dataset_opt in (opt["datasets"] or {}).values():
        if dataset_opt["phase"] == "train":
            train_set = create_dataset(dataset_opt)
            train_loader = create_dataloader(train_set, dataset_opt, opt)
            logger.info("Train set: %d items, %d batches/epoch", len(train_set),
                        len(train_loader))
        elif dataset_opt["phase"] == "val":
            val_set = create_dataset(dataset_opt)
    if train_loader is None:
        raise ValueError("no train dataset in the config")
    n_batches = len(train_loader)
    if n_batches == 0:
        raise ValueError(f"the train set has {len(train_loader.dataset)} items, fewer than "
                         f"one batch of {train_loader.batch_size}: nothing would train")

    model = create_model(opt, device)
    niter = max_iters or int(opt["train"].get("niter") or 600000)
    start_epoch, current_step = 0, 0
    if paths.get("resume_state"):
        saved_epoch = model.resume_training(paths["resume_state"])
        current_step = model.step
        # Every epoch is n_batches long from epoch 0, so the next batch is
        # batch (step mod n) of epoch (step div n). (The JAX CLI skips
        # step mod n batches of the saved epoch, which replays that epoch
        # when the state was saved on its last batch.)
        start_epoch, skip = divmod(current_step, n_batches)
        train_loader.set_skip_batches(skip)
        logger.info("Resumed from iter %d (saved in epoch %d): epoch %d, batch %d",
                    current_step, saved_epoch, start_epoch, skip)

    scale = opt.get("scale", 4)
    noise = noise_range(opt)
    estimator = build_frozen_estimator(opt, device) if which in _META else None

    # This rank's rows of each global batch, for the degradations' draws.
    share = (train_loader.rows.start, train_loader.batch_size)

    def feed(batch, step: int) -> None:
        if which in _META:
            model.feed_data(synthesize_meta_batch(step_generator(seed, step, device),
                                                  batch["HR"], scale, estimator, noise, share))
        elif which in _DOWNSCALER:
            model.feed_data(synthesize_downscaler_batch(
                step_generator(seed, step, device), batch.get("HR", batch.get("GT")), scale,
                noise, share))
        else:
            model.feed_data(batch)

    lg = opt.get("logger") or {}
    print_freq = int(lg.get("print_freq") or 100)
    save_freq = int(lg.get("save_checkpoint_freq") or 5000)
    val_freq = int(opt["train"].get("val_freq") or 5000)
    total_epochs = max(1, math.ceil(niter / n_batches))
    t_last, wait = time.time(), 0.0
    done = False
    for epoch in range(start_epoch, total_epochs + 1):
        if done:
            break
        train_loader.set_epoch(epoch)
        batches = iter(train_loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            wait += time.perf_counter() - t0
            if batch is None:
                break
            if current_step >= niter:
                done = True
                break
            current_step += 1
            feed(batch, current_step)
            model.optimize_parameters(current_step)

            if current_step % print_freq == 0:
                logs = model.get_current_log()
                dt = (time.time() - t_last) / print_freq
                t_last = time.time()
                lr = model.get_current_learning_rate()
                msg = " ".join(f"{k}: {v:.4e}" for k, v in logs.items())
                logger.info("<epoch:%3d, iter:%8d, lr:%.3e, time:%.3fs, data:%.3fs> %s",
                            epoch, current_step, lr, dt, wait / print_freq, msg)
                if tb is not None:
                    tb.add_scalars(current_step, {**logs, "lr": lr, "step_time_s": dt,
                                                  "data_wait_s": wait / print_freq})
                wait = 0.0

            if val_set is not None and current_step % val_freq == 0:
                if primary:
                    _validate(model, val_set, opt, current_step, logger)
                mesh.barrier()

            if current_step % save_freq == 0:
                logger.info("Saving models and training states.")
                model.save(current_step)
                model.save_training_state(epoch, current_step)
        batches.close()

    logger.info("Saving the final model.")
    model.save(current_step)
    model.save_training_state(total_epochs, current_step)
    logger.info("End of training.")
    if tb is not None:
        tb.close()
    return current_step


def _validate(model, val_set, opt: Mapping, step: int, logger: logging.Logger) -> None:
    save_root = None
    if (opt.get("logger") or {}).get("save_val_images"):
        save_root = osp.join(opt["path"]["val_images"], f"iter_{step}")
    results = evaluate_dataset(
        model.make_infer_fn(), val_set,
        n_frames=(opt["network_G"] or {}).get("nframes", 5),
        padding=(opt["datasets"].get("val") or {}).get("padding") or "reflection",
        chunk=model.infer_chunk, save_root=save_root, logger=None)
    if "_avg" in results:
        logger.info("# Validation iter %d # PSNR: %.4f SSIM: %.4f", step,
                    results["_avg"]["psnr_avg"], results["_avg"]["ssim_avg"])


if __name__ == "__main__":
    main()
