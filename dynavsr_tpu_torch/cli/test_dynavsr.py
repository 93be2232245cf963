"""DynaVSR adaptation eval (port of dynavsr_tpu/cli/test_dynavsr.py).

Per clip: the estimator (`network_E`: MFDN, or SFDN frame by frame; fp32
or bf16) turns the adaptation windows into SLR windows, the VSR net
(EDVR, TOF or DUF_16L/28L/52L, `network_G.which_model_G`) takes k
adaptation steps on (SLR window -> LR centre), then slides over the clip
(window-batched, or for EDVR sequence mode with `adapt.seq: true`), and the
frames are scored. `eval.tile` (an int or [th, tw]) with `eval.tile_overlap`
(default 32) runs the inference windows as overlapping spatial tiles
(eval/tiled.py; the adaptation's SLR windows, smaller than a tile, pass
through whole, as in JAX), and `adapt.seq` is off then.
DUF expects blur-matched LR (data/degradations.duf_downsample) and 7
frames a window, and its configs score with `eval.crop_border: 8`.

With `adapt.clip_parallel: true` the clips adapt as one batch per LR
resolution (`run_clips`), spread over the ranks of a torch.distributed
group, one process a card (`--launcher pytorch` under torchrun; at one
process, the clips of a bucket run in turn):

    python -m dynavsr_tpu_torch.cli.test_dynavsr -opt configs/test/test_DynaVSR_Vid4.yml
    python -m torch.distributed.run --nproc_per_node 4 -m dynavsr_tpu_torch.cli.test_dynavsr \
        -opt configs/test/test_DynaVSR_Vid4.yml --launcher pytorch   # adapt.clip_parallel: true
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp
from typing import Optional, Tuple

import numpy as np
import torch

from dynavsr_tpu_torch.adapt.adaptation import (
    AdaptConfig,
    batch_clips,
    batch_clips_seq,
    make_adapt_and_infer,
    make_adapt_and_infer_batched,
    make_adapt_and_infer_seq,
    make_adapt_and_infer_seq_batched,
    resolve_bn_mode,
)
from dynavsr_tpu_torch.data.loader import create_dataset
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.harness import score_frames
from dynavsr_tpu_torch.eval.tiled import make_tiled_apply
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import (
    arch_mod,
    make_model_apply,
    make_mutable_model_apply,
)
from dynavsr_tpu_torch.models.video_base_model import check_n_devices
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.checkpoint import load_pretrained
from dynavsr_tpu_torch.utils.observability import count, span

__all__ = ["run_clip", "run_clips", "build_estimator", "adapt_config", "main", "run"]

logger = logging.getLogger("dynavsr_tpu_torch")


def run_clip(vsr, est, lq: np.ndarray, gt: Optional[np.ndarray], cfg: AdaptConfig, *,
             seq: bool, n_frames: int, padding: str, n_adapt: int, scale: int = 4,
             ycbcr: bool = True, crop_border: int = 0,
             save_dir: Optional[str] = None, device=None, tile=None,
             tile_overlap: Optional[int] = None) -> Tuple[np.ndarray, dict]:
    """Adapt `vsr` (a copy of it) to one clip and super-resolve the clip.

    lq (T, h, w, 3) / gt (T, H, W, 3) float in [0, 1]. vsr's class names
    its architecture (`vsr.arch`: EDVR, TOF or DUF) and so its input convention
    (models/padding.py). `seq` asks for sequence-mode inference, which only
    EDVR has: another net falls back to the window-batched path with a
    warning, as the JAX CLI does. `tile` (an int or (th, tw)) runs the
    window-batched forwards as overlapping tiles (`tile_overlap` pixels,
    None for eval/tiled.TILE_OVERLAP):
    the inference windows, while SLR windows that fit a tile pass through
    and the train_ema forward is never tiled, as in JAX.
    The work runs on `device` (default: cuda;
    see device.resolve_device), where vsr and est must already be
    (define_G / build_estimator with the same device). Returns (sr (T, H, W, 3), scores),
    with the per-step adaptation losses under scores['adapt_losses']."""
    with span("clip"):
        device, seq, apply, mutable = _setup(vsr, est, cfg, seq, scale, device, tile,
                                             tile_overlap)
        which = vsr.arch
        t, h, w = lq.shape[:3]
        win = all_windows(t, n_frames, padding)
        with span("clip.slr"):
            adapt_windows = torch.as_tensor(lq[win[: min(n_adapt, t)]], device=device)
            count("h2d_bytes", adapt_windows.nbytes)
            with torch.no_grad():
                slr_windows = est(adapt_windows)
        lr_centers = adapt_windows[:, n_frames // 2]
        if seq:
            # Mod-pad the clip once: the same math as padding each window.
            mod = arch_mod(which)
            ph, pw = (-h) % mod, (-w) % mod
            frames = np.pad(lq, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect") \
                if ph or pw else lq
            run = make_adapt_and_infer_seq(cfg, apply_fn=apply, mutable_apply_fn=mutable)
            with span("clip.upload"):
                frames = torch.as_tensor(frames, device=device)
                win_idx = torch.as_tensor(win, dtype=torch.long, device=device)
                count("h2d_bytes", frames.nbytes + win_idx.nbytes)
            sr, losses = run(vsr, slr_windows, lr_centers, frames, win_idx)
            sr = sr[:, : h * scale, : w * scale]
        else:
            run = make_adapt_and_infer(cfg, apply_fn=apply, mutable_apply_fn=mutable)
            with span("clip.upload"):
                lr_windows = torch.as_tensor(lq[win], device=device)
                count("h2d_bytes", lr_windows.nbytes)
            sr, losses = run(vsr, slr_windows, lr_centers, lr_windows)
        with span("clip.download"):
            count("d2h_bytes", sr.nbytes)
            sr = sr.cpu().numpy()
        with span("clip.score"):
            res = score_frames(sr, gt, ycbcr=ycbcr, crop_border=crop_border, save_dir=save_dir)
        count("d2h_bytes", losses.nbytes)
        res["adapt_losses"] = losses.cpu().tolist()
    return sr, res


def _setup(vsr, est, cfg: AdaptConfig, seq: bool, scale: int, device, tile, tile_overlap):
    """(device, seq, apply, mutable apply) of a run: the models must be on
    the device; sequence mode only for EDVR and not under tiling; the net's
    input convention, tiled on request; the train-mode forward of
    bn_mode train_ema."""
    device = resolve_device(device)
    for name, module in (("vsr", vsr), ("est", est)):
        on = next(module.parameters()).device
        if on != device:
            raise ValueError(f"{name} is on {on}, but the clip runs on {device}: "
                             f"build it with device={str(device)!r}")
    which = vsr.arch
    seq = seq and not tile
    if seq and which != "EDVR":
        logger.warning("adapt.seq requested but which_model_G=%s has no pyramid-split "
                       "forward: using the window-batched path.", which)
        seq = False
    apply = make_model_apply(which, scale)
    if tile:
        apply = make_tiled_apply(apply, tile, tile_overlap, scale)
    mutable = (make_mutable_model_apply(which, scale)
               if resolve_bn_mode(cfg.bn_mode, vsr) == "train_ema" else None)
    return device, seq, apply, mutable


def run_clips(vsr, est, clips, cfg: AdaptConfig, *, seq: bool, n_frames: int, padding: str,
              n_adapt: int, scale: int = 4, ycbcr: bool = True, crop_border: int = 0,
              save_root: Optional[str] = None, device=None, tile=None,
              tile_overlap: Optional[int] = None) -> Optional[dict]:
    """Clip-parallel adaptation of a set of clips: the JAX CLI's
    adapt.clip_parallel branch over in-memory clips.

    clips: name -> (lq (T, h, w, 3), gt (T, H, W, 3) or None). The clips are
    bucketed by LR resolution; each bucket is padded to a multiple of the
    world size by repeating its last clip (never scored), stacked by
    batch_clips (or batch_clips_seq with `seq`, the frames mod-padded once),
    its adaptation windows run through `est` in one call, and the stack
    adapts and infers clip-parallel (make_adapt_and_infer[_seq]_batched:
    each rank its share of the clips, the SR gathered). A clip shorter than
    n_adapt windows adapts on its windows repeated to n_adapt, as in JAX
    (run_clip takes them once). Rank 0 scores every clip (saving its frames
    under save_root/<name> when set) and returns {name: (sr (T, H, W, 3),
    scores with 'adapt_losses')}, run_clip's pair; the other ranks return
    None. Other arguments as run_clip's."""
    device, seq, apply, mutable = _setup(vsr, est, cfg, seq, scale, device, tile, tile_overlap)
    run_b = (make_adapt_and_infer_seq_batched if seq else make_adapt_and_infer_batched)(
        cfg, apply_fn=apply, mutable_apply_fn=mutable)
    world, center = mesh.get_world_size(), n_frames // 2
    buckets: dict = {}
    for name, (lq, _) in clips.items():
        buckets.setdefault(lq.shape[1:3], []).append(name)
    results = {}
    for (h, w), names in buckets.items():
        lqs = [clips[n][0] for n in names]
        lqs += [lqs[-1]] * ((-len(lqs)) % world)
        if seq:
            frames, win, adapt_w, lr_c, lens = batch_clips_seq(lqs, n_frames, padding, n_adapt,
                                                               center)
            mod = arch_mod(vsr.arch)
            if (-h) % mod or (-w) % mod:
                frames = np.pad(frames, [(0, 0), (0, 0), (0, (-h) % mod), (0, (-w) % mod),
                                         (0, 0)], mode="reflect")
            stacks = (torch.as_tensor(frames, device=device),
                      torch.as_tensor(win, dtype=torch.long, device=device))
        else:
            lr_w, adapt_w, lr_c, lens = batch_clips(
                [lq[all_windows(lq.shape[0], n_frames, padding)] for lq in lqs], n_adapt,
                center)
            stacks = (torch.as_tensor(lr_w, device=device),)
        adapt_w = torch.as_tensor(adapt_w, device=device)
        with torch.no_grad():
            slr = est(adapt_w.flatten(0, 1))
        sr, losses = run_b(vsr, slr.view(adapt_w.shape[:2] + slr.shape[1:]),
                           torch.as_tensor(lr_c, device=device), *stacks)
        if not mesh.is_primary():
            continue
        sr = sr[..., : h * scale, : w * scale, :].cpu().numpy()
        for i, name in enumerate(names):
            res = score_frames(sr[i, : lens[i]], clips[name][1], ycbcr=ycbcr,
                               crop_border=crop_border,
                               save_dir=None if save_root is None else osp.join(save_root, name))
            res["adapt_losses"] = losses[i].cpu().tolist()
            results[name] = (sr[i, : lens[i]], res)
    return results if mesh.is_primary() else None


def build_estimator(opt_est, scale: int, nframes: int, device=None) -> torch.nn.Module:
    """The degradation estimator of a `network_E` config block (MFDN when
    it names none; SFDN; `dtype` as for network_G), through define_G, on
    `device` (default: cuda), in eval mode. MFDN takes `nframes` frames."""
    opt_est = {**opt_est, "which_model_G": opt_est.get("which_model_G") or "MFDN",
               "nframes": nframes}
    return define_G({"scale": scale, "network_G": opt_est}, device).eval()


def adapt_config(a) -> AdaptConfig:
    """AdaptConfig from an `adapt` block; explicit zeros are kept."""
    ic = a.get("infer_chunk")
    return AdaptConfig(
        n_steps=5 if a.get("n_steps") is None else int(a["n_steps"]),
        lr=1e-6 if a.get("lr") is None else float(a["lr"]),
        optimizer=a.get("optimizer") or "adam",
        infer_chunk=8 if ic is None else int(ic),
        bn_mode=a.get("bn_mode") or "auto",
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-opt", required=True)
    parser.add_argument("--no-save-images", action="store_true")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--launcher", default="none",
                        help="none (one process) or pytorch (torchrun, one process a card; "
                             "needs adapt.clip_parallel)")
    args = parser.parse_args(argv)

    from dynavsr_tpu_torch.config.options import parse

    opt = parse(args.opt)
    device = mesh.init_dist(args.launcher, args.device)
    try:
        return run(opt, device, args.no_save_images)
    finally:
        if args.launcher != "none":
            torch.distributed.destroy_process_group()


def run(opt, device, no_save_images: bool) -> dict:
    """`main` on a derived config (config/options.parse, or derive on a
    dict) and a resolved device: {clip: scores, '_avg': ...} (on rank 0;
    other ranks return {})."""
    from dynavsr_tpu_torch.config.options import dict2str

    logging.basicConfig(level=logging.INFO)
    primary = mesh.is_primary()
    if primary:
        logger.info(dict2str(opt))
    a = opt.get("adapt") or {}
    check_n_devices(opt)
    if mesh.get_world_size() > 1 and not a.get("clip_parallel"):
        raise ValueError(f"{mesh.get_world_size()} ranks serve a test set clip-parallel "
                         "only: set adapt.clip_parallel")

    scale = opt.get("scale", 4)
    n_frames = (opt["network_G"] or {}).get("nframes", 5)
    vsr = define_G(opt, device)
    est = build_estimator(opt.get("network_E") or {}, scale, n_frames, device)
    strict = opt["path"].get("strict_load", True) is not False
    load_pretrained(vsr, opt["path"].get("pretrain_model_G"), strict)
    load_pretrained(est, opt["path"].get("pretrain_model_E"), strict)
    mesh.replicate(vsr)
    mesh.replicate(est)
    cfg = adapt_config(a)
    ev = opt.get("eval") or {}
    common = dict(seq=bool(a.get("seq")), n_frames=n_frames,
                  n_adapt=int(a.get("n_windows") or 8), scale=scale,
                  ycbcr=bool(ev.get("ycbcr", True)),
                  crop_border=int(ev.get("crop_border") or 0), device=device,
                  tile=ev.get("tile"), tile_overlap=ev.get("tile_overlap"))

    def log_clip(clip, res):
        results[clip] = res
        if "psnr_avg" in res:
            logger.info("Clip %s: PSNR %.4f SSIM %.4f (adapted, %d steps)",
                        clip, res["psnr_avg"], res["ssim_avg"], cfg.n_steps)

    results = {}
    for _name, dataset_opt in (opt["datasets"] or {}).items():
        test_set = create_dataset(dataset_opt)
        padding = dataset_opt.get("padding") or "reflection"

        def gt_of(c, test_set=test_set):  # a clip without GT frames is not scored
            return test_set.clip_frames(c, gt=True) if test_set.has_gt(c) else None

        if a.get("clip_parallel"):
            clips = {c: (test_set.clip_frames(c), gt_of(c)) for c in test_set.names}
            res = run_clips(vsr, est, clips, cfg, padding=padding, save_root=None
                            if no_save_images else opt["path"]["results_root"], **common)
            for clip, (_, r) in (res or {}).items():
                log_clip(clip, r)
            continue
        for clip in test_set.names:
            log_clip(clip, run_clip(
                vsr, est, test_set.clip_frames(clip), gt_of(clip), cfg, padding=padding,
                save_dir=None if no_save_images else osp.join(
                    opt["path"]["results_root"], clip), **common)[1])
    scored = [r for r in results.values() if "psnr_avg" in r]
    if scored:
        results["_avg"] = {"psnr_avg": float(np.mean([r["psnr_avg"] for r in scored])),
                           "ssim_avg": float(np.mean([r["ssim_avg"] for r in scored]))}
        logger.info("Average (adapted): PSNR %.4f SSIM %.4f",
                    results["_avg"]["psnr_avg"], results["_avg"]["ssim_avg"])
    return results if primary else {}


if __name__ == "__main__":
    main()
