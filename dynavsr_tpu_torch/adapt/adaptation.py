"""Test-time adaptation — the DynaVSR product loop (port of
dynavsr_tpu/adapt/adaptation.py).

Per clip: copy the meta weights, take k optimizer steps on the
self-supervised pseudo-task (SLR window = MFDN(LR window) -> LR centre),
then run the adapted net over every sliding window of the clip.

Where the JAX functions take `params`, these take the module that holds
them. Every clip starts from a fresh deep copy of that module (its
BatchNorm running statistics included) and a fresh optimizer: JAX's
functional update cannot leak one clip's adaptation into the next, and an
in-place torch loop would unless it copies.

BatchNorm nets (TOF, DUF) adapt in one of two `bn_mode`s:

* 'train_ema', the reference's train()-mode semantics: the adaptation
  forward runs the module in train mode (batch statistics; the running
  statistics move by the module's EMA, in place), gradients move the
  trainable parameters, and inference runs in eval mode on the EMA'd
  statistics. 'auto' resolves to it for nets with BatchNorm.
* 'grad_stats', the JAX package's variant: the adaptation forward runs in
  eval mode, and the optimizer steps the running statistics together with
  the weights (in JAX the adapted `params` is the whole variables dict).
  The statistics stay buffers, so the state_dict keys do not change; they
  require grad only while the copy adapts. On a net without BatchNorm
  (EDVR, 'auto') this is plain gradient steps.

The optimizer is optax's: 'adam' (betas 0.9 / 0.999, eps 1e-8) or 'sgd'
(no momentum, no weight decay), at `lr`.

Clip-parallel adaptation (`make_adapt_and_infer_batched`, `_seq_batched`)
takes stacks of C clips padded to common shapes (`batch_clips`,
`batch_clips_seq`). Each rank of a torch.distributed group runs its
contiguous share of the clips one after another, one module copy a clip,
with dense convs: JAX's `_clip_parallel` design (a `lax.map` over the
clips on each device, the clips sharded over the mesh), chosen there
because vmapping over per-clip weights measured 1.93x slower. The results
are then assembled on every rank (parallel/mesh.gather_rows).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.losses import charbonnier_loss
from dynavsr_tpu_torch.utils.observability import span

__all__ = ["AdaptConfig", "chunked_apply", "has_batch_norm", "resolve_bn_mode",
           "make_adapt_fn", "make_adapt_and_infer", "make_adapt_and_infer_seq", "seq_forward",
           "make_adapt_and_infer_batched", "make_adapt_and_infer_seq_batched", "batch_clips",
           "batch_clips_seq"]


@dataclasses.dataclass
class AdaptConfig:
    n_steps: int = 5
    lr: float = 1e-6
    optimizer: str = "adam"  # 'adam' | 'sgd'
    reduction: str = "mean"
    infer_chunk: int = 0  # 0 = all windows in one batch
    bn_mode: str = "auto"  # 'auto' | 'train_ema' | 'grad_stats' (see the module note)


def _running_stats(model: nn.Module) -> list:
    """Every BatchNorm's running_mean and running_var buffers."""
    return [buf for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for buf in (m.running_mean, m.running_var)]


def has_batch_norm(model: nn.Module) -> bool:
    return bool(_running_stats(model))


def resolve_bn_mode(bn_mode: str, model: nn.Module) -> str:
    """'auto' -> 'train_ema' for nets with BatchNorm (TOF, DUF), 'grad_stats'
    otherwise (EDVR); an explicit mode is returned as it is."""
    if bn_mode != "auto":
        return bn_mode
    return "train_ema" if has_batch_norm(model) else "grad_stats"


def chunked_apply(apply: Callable, windows: torch.Tensor, chunk: int) -> torch.Tensor:
    """apply() over (F, ...) windows, `chunk` rows per call to bound live
    activation memory; chunk=0 or chunk >= F runs one batch. Rows are
    independent, so the last chunk may be short (the JAX version pads it)."""
    if not chunk or chunk >= windows.shape[0]:
        return apply(windows)
    return torch.cat([apply(windows[s: s + chunk])
                      for s in range(0, windows.shape[0], chunk)], dim=0)


def _make_opt(cfg: AdaptConfig, params) -> torch.optim.Optimizer:
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)  # optax.adam
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr)  # optax.sgd
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


def _train_mode_apply(model, x):
    model.train()
    return model(x)


def _eval_mode_apply(model, x):
    model.eval()
    return model(x)


def make_adapt_fn(cfg: AdaptConfig, apply_fn: Optional[Callable] = None,
                  mutable_apply_fn: Optional[Callable] = None) -> Callable:
    """adapt(meta_model, slr_windows, lr_centers) -> (adapted_model, losses).

    apply_fn(model, x) overrides model(x), e.g. the mod-padded apply of
    models/padding.py. In 'train_ema' mode the adaptation forward is
    mutable_apply_fn(model, x) instead, which must run the module in train
    mode (default: model.train() then model(x);
    models/padding.make_mutable_model_apply builds the padded one). losses
    (n_steps,) are taken before each update, as jax.value_and_grad gives
    them."""
    apply = apply_fn or _eval_mode_apply

    def adapt(meta_model, slr_windows, lr_centers):
        mode = resolve_bn_mode(cfg.bn_mode, meta_model)
        if mode not in ("train_ema", "grad_stats"):
            raise ValueError(f"unknown bn_mode {cfg.bn_mode!r}")
        with span("adaptation"):
            with span("adaptation.copy"):
                model = copy.deepcopy(meta_model)
            forward = (mutable_apply_fn or _train_mode_apply) if mode == "train_ema" else apply
            stats = _running_stats(model) if mode == "grad_stats" else []
            for buf in stats:
                buf.requires_grad_(True)
            opt = _make_opt(cfg, [*model.parameters(), *stats])
            losses = []
            for _ in range(cfg.n_steps):
                with span("adaptation.step"):
                    opt.zero_grad(set_to_none=True)
                    loss = charbonnier_loss(forward(model, slr_windows), lr_centers,
                                            reduction=cfg.reduction)
                    loss.backward()
                    opt.step()
                    losses.append(loss.detach())
            for buf in stats:
                buf.requires_grad_(False)
            out = torch.stack(losses) if losses else torch.zeros(0, device=lr_centers.device)
        return model, out

    return adapt


def make_adapt_and_infer(cfg: AdaptConfig, apply_fn: Optional[Callable] = None,
                         mutable_apply_fn: Optional[Callable] = None) -> Callable:
    """run(meta_model, slr_windows, lr_centers, lr_windows) -> (sr, losses).

    slr_windows (K, N, h/s, w/s, 3) adaptation inputs (from MFDN);
    lr_centers (K, h, w, 3) their targets; lr_windows (F, N, h, w, 3)
    every sliding window of the clip. sr: (F, H, W, 3). Inference runs the
    adapted module in eval mode (apply_fn must set it, as
    models/padding.make_model_apply does)."""
    adapt = make_adapt_fn(cfg, apply_fn, mutable_apply_fn)
    apply = apply_fn or _eval_mode_apply

    def run(meta_model, slr_windows, lr_centers, lr_windows):
        adapted, losses = adapt(meta_model, slr_windows, lr_centers)
        with span("clip.infer"), torch.no_grad():
            sr = chunked_apply(lambda w: apply(adapted, w), lr_windows, cfg.infer_chunk)
        return sr, losses

    return run


def make_adapt_and_infer_seq(cfg: AdaptConfig, apply_fn: Optional[Callable] = None,
                             mutable_apply_fn: Optional[Callable] = None) -> Callable:
    """Sequence-mode adapt+infer: the same adaptation, then
    EDVR.forward_seq semantics for inference.

    run(meta_model, slr_windows, lr_centers, frames, win_idx):
      frames (T, h, w, 3) the clip, already mod-4 padded by the caller;
      win_idx (F, N) sliding-window indices (data/windows.all_windows).
    apply_fn drives only the adaptation pseudo-task."""
    adapt = make_adapt_fn(cfg, apply_fn, mutable_apply_fn)

    def run(meta_model, slr_windows, lr_centers, frames, win_idx):
        adapted, losses = adapt(meta_model, slr_windows, lr_centers)
        with span("clip.infer"), torch.no_grad():
            sr = seq_forward(adapted, frames, win_idx, cfg.infer_chunk)
        return sr, losses

    return run


def seq_forward(model, frames: torch.Tensor, win_idx: torch.Tensor,
                infer_chunk: int = 0) -> torch.Tensor:
    """Per-frame pyramids extracted once for the (T, H, W, 3) clip, gathered
    per (F, N) window row for PCD + fusion; infer_chunk bounds the fusion
    stage. Exact against the window-batched forward."""
    l1, l2, l3 = model.extract_pyramid(frames)
    n = win_idx.shape[1]
    center = n // 2 if model.center is None else model.center

    def fuse(idx):
        return model.fuse_pyramid(l1[idx], l2[idx], l3[idx], frames[idx[:, center]])

    return chunked_apply(fuse, win_idx, infer_chunk)


def _clip_parallel(single: Callable) -> Callable:
    """run(meta_model, *stacks) -> (sr (C, ...), losses (C, n_steps)):
    `single` (one clip's adapt + infer) over the leading clips axis of the
    stacks. Each rank runs its contiguous share of the C clips in turn (C
    must divide by the world size), and the results are gathered onto every
    rank, so every rank returns the whole stack, as JAX's sharded output
    holds it."""

    def run(meta_model, *stacks):
        c = stacks[0].shape[0]
        rows = mesh.batch_rows(c)
        outs = [single(meta_model, *(s[i] for s in stacks)) for i in range(rows.start, rows.stop)]
        sr = torch.stack([o[0] for o in outs])
        losses = torch.stack([o[1] for o in outs])
        return mesh.gather_rows(sr, c, rows), mesh.gather_rows(losses, c, rows)

    return run


def make_adapt_and_infer_batched(cfg: AdaptConfig, apply_fn: Optional[Callable] = None,
                                 mutable_apply_fn: Optional[Callable] = None) -> Callable:
    """Clip-parallel make_adapt_and_infer: run(meta_model, slr_windows (C,
    K, N, h/s, w/s, 3), lr_centers (C, K, h, w, 3), lr_windows (C, F, N, h,
    w, 3)) -> (sr (C, F, H, W, 3), losses (C, n_steps)). Every clip adapts
    its own copy of meta_model; the stacks come from batch_clips (padded
    rows repeat the last window; callers slice sr[i, :lengths[i]])."""
    return _clip_parallel(make_adapt_and_infer(cfg, apply_fn, mutable_apply_fn))


def make_adapt_and_infer_seq_batched(cfg: AdaptConfig, apply_fn: Optional[Callable] = None,
                                     mutable_apply_fn: Optional[Callable] = None) -> Callable:
    """Clip-parallel make_adapt_and_infer_seq: run(meta_model, slr_windows
    (C, K, N, h/s, w/s, 3), lr_centers (C, K, h, w, 3), frames (C, T, h, w,
    3), win_idx (C, F, N)) -> (sr (C, F, H, W, 3), losses (C, n_steps)),
    from batch_clips_seq's stacks (frames mod-4 padded by the caller)."""
    return _clip_parallel(make_adapt_and_infer_seq(cfg, apply_fn, mutable_apply_fn))


def _adapt_index(f: int, n_adapt: int) -> np.ndarray:
    """The adaptation windows of a clip of f windows: the first n_adapt, or
    for a shorter clip all f repeated in turn up to n_adapt (JAX's batched
    selection; the per-clip path, cli/test_dynavsr.run_clip, takes a short
    clip's f windows once, so the two differ there, in JAX too)."""
    return np.resize(np.arange(min(f, n_adapt)), n_adapt)


def _check_uniform_hw(shapes, fn_name: str) -> None:
    """Clip batching pads T / F only: a set of mixed (h, w) clips must be
    bucketed by resolution first (cli/test_dynavsr.run_clips does)."""
    if len(set(map(tuple, shapes))) > 1:
        raise ValueError(
            f"{fn_name} requires uniform (h, w) across clips, got "
            f"{sorted(set(map(tuple, shapes)))} — bucket clips by "
            "resolution and batch each bucket separately")


def batch_clips(clip_windows, n_adapt: int, center: int):
    """Pad per-clip window stacks (F_i, N, h, w, 3) to a common frame count
    (numpy in, numpy out). Returns (lr_windows (C, Fmax, N, h, w, 3),
    adaptation windows (C, K, N, h, w, 3), lr_centers (C, K, h, w, 3),
    lengths); padding repeats the last window."""
    _check_uniform_hw([w.shape[2:4] for w in clip_windows], "batch_clips")
    fmax = max(w.shape[0] for w in clip_windows)
    lw, aw, lc, lens = [], [], [], []
    for w in clip_windows:
        f = w.shape[0]
        lw.append(np.concatenate([w, np.repeat(w[-1:], fmax - f, axis=0)], axis=0)
                  if f < fmax else w)
        sel = w[_adapt_index(f, n_adapt)]
        aw.append(sel)
        lc.append(sel[:, center])
        lens.append(f)
    return np.stack(lw), np.stack(aw), np.stack(lc), lens


def batch_clips_seq(clips, n_frames: int, padding: str, n_adapt: int, center: int):
    """Pad raw clips (T_i, h, w, 3) and their sliding-window index tables to
    common shapes for the batched sequence path (numpy in, numpy out).
    Returns (frames (C, Tmax, h, w, 3), win_idx (C, Tmax, N) int32,
    adaptation windows (C, K, N, h, w, 3), lr_centers (C, K, h, w, 3),
    lengths): Tmax is a multiple of 8, padding repeats the last frame and the
    last window row, and the adaptation windows are batch_clips' selection."""
    _check_uniform_hw([c.shape[1:3] for c in clips], "batch_clips_seq")
    tmax = -(-max(c.shape[0] for c in clips) // 8) * 8
    frames, wins, aw, lc, lens = [], [], [], [], []
    for c in clips:
        t = c.shape[0]
        win = all_windows(t, n_frames, padding)
        frames.append(np.concatenate([c, np.repeat(c[-1:], tmax - t, axis=0)], axis=0)
                      if t < tmax else c)
        wins.append(np.concatenate([win, np.repeat(win[-1:], tmax - t, axis=0)], axis=0)
                    if t < tmax else win)
        sel = c[win[_adapt_index(t, n_adapt)]]
        aw.append(sel)
        lc.append(sel[:, center])
        lens.append(t)
    return (np.stack(frames), np.stack(wins).astype(np.int32), np.stack(aw), np.stack(lc),
            lens)
