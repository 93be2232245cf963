"""Supervised VSR training step (port of dynavsr_tpu/train/trainer.py).

The JAX package's step is one jitted function of a (params, opt_state,
step) state. Here the module and a torch optimizer hold that state, and
`make_train_step` returns a function that updates both in place from one
batch and the count of updates made before it.

The update is optax's chain, not torch's defaults:
clip_by_global_norm -> scale_by_adam(b1, b2, eps 1e-8) ->
add_decayed_weights(wd) -> scale_by_learning_rate(sched). Without decay
that is torch.optim.Adam; with it, torch.optim.AdamW (decay decoupled and
scaled by the lr). torch.optim.Adam(weight_decay=...) would add L2 to the
gradient, another function. The clip is optax's rule: the gradients are
scaled by max_norm / norm only when norm >= max_norm (clip_grad_norm_ adds
1e-6 to the norm). The lr of update t (1-based) is sched(t - 1), set on the
param groups before each step.

Under torch.distributed each rank's batch is its share of the global batch
(parallel/mesh.py): the step all-reduces the gradients (averaged for
`reduction: mean`, summed for `sum`) before the clip and the update, and
its metrics the same way, so every rank takes JAX's sharded step on the
global batch and logs what JAX logs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from dynavsr_tpu_torch.models.arch_util import global_batch_stats
from dynavsr_tpu_torch.models.edvr import DCNSep
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.losses import make_pixel_criterion
from dynavsr_tpu_torch.train.schedules import (
    cosine_annealing_restart,
    multistep_restart,
    with_warmup,
)

__all__ = ["TrainerConfig", "make_schedule", "make_optimizer", "make_train_step",
           "apply_update"]


@dataclasses.dataclass
class TrainerConfig:
    lr: float = 4e-4
    beta1: float = 0.9
    beta2: float = 0.99
    weight_decay: float = 0.0
    scheme: str = "CosineAnnealingLR_Restart"
    periods: Tuple[int, ...] = (150000, 150000, 150000, 150000)
    restart_weights: Tuple[float, ...] = (1.0, 0.5, 0.5, 0.5)
    eta_min: float = 1e-7
    milestones: Tuple[int, ...] = ()
    gamma: float = 0.5
    warmup_iter: int = -1
    pixel_weight: float = 1.0
    criterion: str = "cb"  # 'cb' | 'l1' | 'l2'
    reduction: str = "mean"
    grad_clip: Optional[float] = None


def make_schedule(cfg: TrainerConfig) -> Callable[[int], float]:
    if cfg.scheme == "CosineAnnealingLR_Restart":
        sched = cosine_annealing_restart(cfg.lr, cfg.periods, cfg.restart_weights, cfg.eta_min)
    elif cfg.scheme == "MultiStepLR_Restart":
        sched = multistep_restart(cfg.lr, cfg.milestones, cfg.gamma)
    elif cfg.scheme == "constant":
        sched = lambda c: cfg.lr  # noqa: E731
    else:
        raise ValueError(f"unknown lr scheme {cfg.scheme!r}")
    return with_warmup(sched, cfg.warmup_iter)


def make_optimizer(cfg: TrainerConfig, params: Iterable[nn.Parameter]) -> torch.optim.Optimizer:
    """Adam (optax's scale_by_adam, eps 1e-8), or AdamW when
    cfg.weight_decay is set. The lr is the step function's to set."""
    kw = dict(lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.weight_decay:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def apply_update(optimizer: torch.optim.Optimizer, params, lr: float,
                 grad_clip: Optional[float]) -> torch.Tensor:
    """One optimizer step on the gradients the params hold, at `lr`, after
    optax's clip rule; returns the global norm of the unclipped gradients."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    grads = [p.grad for p in params if p.grad is not None]
    gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if grad_clip:
        clip = gnorm >= grad_clip
        for g in grads:
            g.copy_(torch.where(clip, g / gnorm * grad_clip, g))
    optimizer.step()
    return gnorm


def _dcn_offset_hooks(model: nn.Module, out: list) -> list:
    """Forward hooks on every DCNSep's conv_offset_mask that append the mean
    |offset| (its first 2*Gd*9 channels) in fp32 to `out`; the JAX package
    sows the same value (models/edvr.py:DCNSep)."""
    handles = []
    for mod in model.modules():
        if isinstance(mod, DCNSep):
            n_off = 2 * mod.gd * 9

            def hook(_m, _inp, om, n_off=n_off):
                out.append(om[:, :n_off].detach().to(torch.float32).abs().mean())

            handles.append(mod.conv_offset_mask.register_forward_hook(hook))
    return handles


def make_train_step(model: nn.Module, cfg: TrainerConfig, optimizer: torch.optim.Optimizer
                    ) -> Callable[[Mapping[str, torch.Tensor], int], Dict[str, torch.Tensor]]:
    """step(batch, count) -> metrics, updating `model` and `optimizer` in
    place. batch: {'LQs': (B, N, h, w, 3), 'GT': (B, H, W, 3)} on the
    model's device; count: the updates made before this one.

    The module runs in train mode, so nets with BatchNorm (TOF, DUF)
    normalise with batch statistics and their running statistics move by
    the layers' own EMA (flax's rule, models/arch_util.py). They are
    buffers, outside the optimizer: in JAX they get exactly-zero gradients
    and the mutable update overwrites them, which comes to the same.

    metrics (0-d tensors): l_pix, the loss before the update; grad_norm,
    the global norm of the unclipped gradients; and for nets with DCNs
    dcn_offset_absmean, the largest mean |offset| over them; each the
    global batch's under torch.distributed. There the train-mode BatchNorm
    normalises with the global batch's statistics (global_batch_stats)."""
    cri_pix = make_pixel_criterion(cfg.criterion, cfg.reduction)
    sched = make_schedule(cfg)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Mapping[str, torch.Tensor], count: int) -> Dict[str, torch.Tensor]:
        model.train()
        offsets: list = []
        handles = _dcn_offset_hooks(model, offsets)
        try:
            with global_batch_stats(model):
                pred = model(batch["LQs"])
        finally:
            for h in handles:
                h.remove()
        l_pix = cfg.pixel_weight * cri_pix(pred, batch["GT"])
        optimizer.zero_grad(set_to_none=True)
        l_pix.backward()
        mesh.all_reduce_grads(params, cfg.reduction)
        gnorm = apply_update(optimizer, params, sched(count), cfg.grad_clip)
        metrics = {"l_pix": mesh.reduce_value(l_pix.detach(), cfg.reduction), "grad_norm": gnorm}
        if offsets:  # each DCN's mean over the global batch, then the largest
            metrics["dcn_offset_absmean"] = mesh.reduce_value(torch.stack(offsets)).max()
        return metrics

    return step
