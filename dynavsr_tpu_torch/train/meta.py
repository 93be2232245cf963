"""MAML-style meta-training, DynaVSR's Algorithm 1 (port of
dynavsr_tpu/train/meta.py).

Per step:
  inner:  theta' = theta - alpha * grad_theta L(f_theta(SLR windows), LR centres)
          (k SGD steps on fast weights; the outer gradient flows through them)
  outer:  L(f_theta'(LR windows), HR centres) -> one optimizer step on theta.

The fast weights are a dict of tensors run through the module with
`torch.func.functional_call`. The inner gradient is
`torch.autograd.grad(..., create_graph=not first_order)`: second order
differentiates through the inner backward, which on the card is the DCN's
K1-K3 and K8-K10 (ops/dcn.py), the warp's K4 / K5 and K11 / K12
(ops/grid_sample.py) and the dynamic filter's K6 / K7 (ops/duf_filter.py).
`first_order` detaches the inner gradient (FOMAML), as the JAX package's
stop_gradient does. `use_remat` runs the inner forward under
`torch.utils.checkpoint(use_reentrant=False)`: its activations are
recomputed in the backward instead of kept, as jax.checkpoint does.

What is differentiated is the JAX package's: its meta step takes the
gradient over the whole flax variables dict, so for the BatchNorm nets (TOF,
DUF, whose meta forwards run in eval mode) the running means and variances
get meta gradients, move by the inner SGD step and take the outer
optimizer's step like any weight (`meta_variables`). Here they stay buffers
under torch's keys: the step differentiates leaf copies of them and hands
the optimizer their gradients; the eval BatchNorm takes its written-out
formula for statistics that require grad (models/arch_util.py).

Under torch.distributed each rank holds its share of the global batch
(parallel/mesh.py). JAX's inner loss is the mean over the global batch, so
the inner gradient is all-reduced inside the graph (mesh.all_reduce_sum,
whose backward is again an all-reduce): every rank then holds the same fast
weights, and the outer gradient reaches the other ranks' inner losses
through it. The outer gradients and the metrics are all-reduced as the
supervised step's are (averaged for `reduction: mean`, summed for `sum`).
DDP's hooks would not see the fast weights, which functional_call runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.losses import charbonnier_loss
from dynavsr_tpu_torch.train.trainer import apply_update

__all__ = ["MetaConfig", "meta_variables", "adapted_params", "meta_loss",
           "make_meta_train_step"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class MetaConfig:
    inner_lr: float = 1e-5
    inner_steps: int = 1
    first_order: bool = False
    pixel_weight: float = 1.0
    reduction: str = "mean"
    use_remat: bool = True


def meta_variables(model: nn.Module) -> Params:
    """What the meta gradient differentiates and the outer optimizer steps,
    name -> tensor: the trainable parameters, then every BatchNorm's running
    mean and variance (flax's `batch_stats`; not num_batches_tracked), as
    the JAX package's meta step takes the whole variables dict."""
    out = {n: p for n, p in model.named_parameters() if p.requires_grad}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm) and mod.track_running_stats:
            prefix = f"{name}." if name else ""
            out[f"{prefix}running_mean"] = mod.running_mean
            out[f"{prefix}running_var"] = mod.running_var
    return out


class _Applied(nn.Module):
    """`apply_fn(net, x)` as a module, so functional_call can swap the net's
    parameters under an input convention (models/padding.py)."""

    def __init__(self, net: nn.Module, apply_fn: Optional[Callable]):
        super().__init__()
        self.net = net
        self._apply_fn = apply_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x) if self._apply_fn is None else self._apply_fn(self.net, x)


def _forward(model: nn.Module, apply_fn: Optional[Callable]
             ) -> Callable[[Params, torch.Tensor], torch.Tensor]:
    """(params, x) -> the net's output with `params` in place of its own."""
    applied = _Applied(model, apply_fn)

    def fwd(params: Params, x: torch.Tensor) -> torch.Tensor:
        return functional_call(applied, {f"net.{k}": v for k, v in params.items()}, (x,))

    return fwd


def adapted_params(model: nn.Module, params: Params, slr: torch.Tensor,
                   lr_center: torch.Tensor, cfg: MetaConfig,
                   apply_fn: Optional[Callable] = None) -> Tuple[Params, torch.Tensor]:
    """k inner SGD steps on the (SLR windows -> LR centres) pseudo-task.

    slr (B, N, h/s, w/s, 3); lr_center (B, h, w, 3); params: name ->
    tensor, as meta_variables(model) (parameters and BatchNorm running
    statistics; each that requires grad moves). Returns the fast weights
    and the last inner loss (before its step). apply_fn(net, x) overrides
    net(x), e.g. a mod-padded forward (models/padding.make_model_apply),
    since SLR = LR / s is generally not pyramid-divisible."""
    fwd = _forward(model, apply_fn)
    names = list(params)
    loss = None
    for _ in range(cfg.inner_steps):
        if cfg.use_remat:
            pred = checkpoint(fwd, params, slr, use_reentrant=False)
        else:
            pred = fwd(params, slr)
        loss = charbonnier_loss(pred, lr_center, reduction=cfg.reduction)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    create_graph=not cfg.first_order, allow_unused=True)
        grads = _global_inner_grads(grads, [params[k] for k in names], cfg.reduction)
        step = {}
        for k, g in zip(names, grads):
            if g is None:  # unused by the forward: a zero gradient, as in JAX
                step[k] = params[k]
                continue
            if cfg.first_order:
                g = g.detach()
            step[k] = params[k] - cfg.inner_lr * g
        params = step
    return params, loss


def _global_inner_grads(grads, like, reduction: str):
    """The inner gradients of the global batch's loss: one differentiable
    all-reduce of the flattened local gradients (zeros where the forward
    does not reach a variable, on every rank alike), divided by the world
    size for a mean-reduced loss. The identity at world size 1."""
    world = mesh.get_world_size()
    if world == 1:
        return grads
    full = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, like)]
    flat = mesh.all_reduce_sum(torch.cat([g.reshape(-1) for g in full]))
    if reduction == "mean":
        flat = flat / world
    return [part.view_as(t) for part, t in zip(flat.split([t.numel() for t in like]), like)]


def meta_loss(model: nn.Module, params: Params, batch: Mapping[str, torch.Tensor],
              cfg: MetaConfig, apply_fn: Optional[Callable] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(outer loss, last inner loss) of the meta objective at `params`:
    the adapted weights' Charbonnier loss on (LR windows -> HR centres),
    times pixel_weight. Its gradient with respect to `params` is the meta
    gradient (second order unless cfg.first_order)."""
    fast, inner = adapted_params(model, params, batch["SLR"], batch["LR_center"], cfg,
                                 apply_fn)
    pred = _forward(model, apply_fn)(fast, batch["LR"])
    outer = cfg.pixel_weight * charbonnier_loss(pred, batch["HR_center"],
                                                reduction=cfg.reduction)
    return outer, inner


def make_meta_train_step(model: nn.Module, cfg: MetaConfig, optimizer: torch.optim.Optimizer,
                         sched: Callable[[int], float], grad_clip: Optional[float] = None,
                         apply_fn: Optional[Callable] = None
                         ) -> Callable[[Mapping[str, torch.Tensor], int], Dict[str, torch.Tensor]]:
    """step(batch, count) -> metrics, updating `model` and `optimizer` in
    place; count is the updates made before this one (the lr is
    sched(count)).

    batch: {'SLR': (B, N, h/s, w/s, 3), 'LR': (B, N, h, w, 3),
    'LR_center': (B, h, w, 3), 'HR_center': (B, H, W, 3)} on the model's
    device; the (SLR, LR) pair comes from the degradation pipeline (an
    estimator's output or a synthetic kernel). apply_fn(net, x) overrides
    net(x) for both the inner and the outer forward.

    metrics (0-d tensors): l_outer, l_inner and grad_norm (the global norm
    of the meta gradient, before any clip). `optimizer` holds
    meta_variables(model), the BatchNorm statistics included; their
    gradients come from leaf copies that require grad, and a variable the
    loss does not reach gets a zero gradient, as in JAX."""
    names = list(meta_variables(model))

    def step(batch: Mapping[str, torch.Tensor], count: int) -> Dict[str, torch.Tensor]:
        held = meta_variables(model)
        held = [held[k] for k in names]
        leaves = {k: t if t.requires_grad else t.detach().requires_grad_()
                  for k, t in zip(names, held)}
        optimizer.zero_grad(set_to_none=True)
        outer, inner = meta_loss(model, leaves, batch, cfg, apply_fn)
        grads = torch.autograd.grad(outer, list(leaves.values()), allow_unused=True)
        for t, g in zip(held, grads):
            t.grad = torch.zeros_like(t) if g is None else g
        mesh.all_reduce_grads(held, cfg.reduction)
        gnorm = apply_update(optimizer, held, sched(count), grad_clip)
        losses = mesh.reduce_value(torch.stack([outer.detach(), inner.detach()]), cfg.reduction)
        return {"l_outer": losses[0], "l_inner": losses[1], "grad_norm": gnorm}

    return step
