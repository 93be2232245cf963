"""Data and clip parallelism over torch.distributed (port of
dynavsr_tpu/parallel/mesh.py).

The JAX package runs one process over a ('data',) device mesh: batches are
sharded over it, parameters replicated, and XLA emits the gradient psum
inside the jitted step. The port runs one process a card (the PyTorch
idiom: `torchrun`, `--launcher pytorch`) and does by hand what the mesh does
for JAX, so that a W-rank run computes the function of the *global* batch
that JAX computes, up to the order of fp32 sums:

- `init_dist`: the process group from torchrun's environment (NCCL on
  cards, gloo on the CPU; gloo on cards where several ranks share one);
- `replicate`: rank 0's parameters and buffers broadcast to every rank;
- `batch_rows` / `process_local_slice`: the rank's share of the data;
- `all_reduce_grads` / `reduce_value`: one flat all-reduce of a step's
  gradients or metrics, averaged for `reduction: mean` (equal shares), summed
  for `sum`;
- `all_reduce_sum`: a differentiable all-reduce, for sums taken inside a
  graph (the meta step's inner gradient, train-mode BatchNorm statistics
  under models/arch_util.global_batch_stats);
- `gather_rows` / `gather_objects`: results assembled on every rank (device
  tensors, by all_reduce) or on rank 0 (host objects).

Device collectives stay `all_reduce` and `broadcast`: gloo takes those on
CUDA tensors (and nothing else on them), which is how several ranks share
one card. With no process group, or a group of one, every helper is the
identity and costs nothing.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from dynavsr_tpu_torch.device import resolve_device

__all__ = ["init_dist", "get_rank", "get_world_size", "is_primary", "barrier", "replicate",
           "batch_rows", "process_local_slice", "all_reduce_grads", "reduce_value",
           "all_reduce_sum", "gather_rows", "gather_objects", "free_port"]

LAUNCHERS = ("none", "pytorch")


def init_dist(launcher: str = "none", device=None, backend: Optional[str] = None
              ) -> torch.device:
    """The device this rank runs on, with the process group made.

    launcher 'none': no group (world size 1), the device as resolve_device
    gives it. 'pytorch': a group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) through `env://`;
    on cards each rank takes the card LOCAL_RANK, with NCCL unless `backend`
    says otherwise (gloo lets several ranks share a card, which NCCL
    refuses); on the CPU, gloo. A CUDA device with no card raises, as
    resolve_device does. Any other launcher raises."""
    if launcher not in LAUNCHERS:
        raise ValueError(f"--launcher {launcher!r}: expected one of {LAUNCHERS}")
    dev = torch.device("cuda" if device is None else device)
    if launcher == "none":
        return resolve_device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method="env://")
    return dev


def free_port() -> int:
    """A free TCP port on this host, for a group of spawned ranks."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, the one that writes files and logs."""
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def replicate(module: nn.Module) -> nn.Module:
    """Rank 0's parameters and buffers, broadcast in place to every rank
    (JAX's `replicate`); returns the module."""
    if get_world_size() > 1:
        with torch.no_grad():
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, 0)
    return module


def batch_rows(n: int, rank: Optional[int] = None, world: Optional[int] = None) -> slice:
    """The rank's contiguous share of n rows (a global batch, or a padded
    stack of clips); n must divide by the world size."""
    r = get_rank() if rank is None else rank
    w = get_world_size() if world is None else world
    if n % w:
        raise ValueError(f"{n} rows do not divide over {w} ranks: the global batch size "
                         f"must be a multiple of the world size")
    k = n // w
    return slice(r * k, (r + 1) * k)


def process_local_slice(n: int, seed: int, epoch: int, ratio: int = 1, rank: int = 0,
                        world: int = 1) -> np.ndarray:
    """JAX's per-process index stream: a shuffle of `ratio` epoch-inflations
    of range(n), from (seed + epoch), strided over the processes. At rank 0
    of 1 it is the whole epoch's stream, which data/loader.PrefetchLoader
    cuts into global batches and shares out by batch_rows, so that every
    rank's batch is its contiguous share of the one-process batch."""
    rng = np.random.default_rng(seed + epoch)
    idx = np.concatenate([rng.permutation(n) for _ in range(max(1, ratio))])
    return idx[rank::world]


def _mean_divisor(reduction: str) -> int:
    if reduction == "mean":
        return get_world_size()
    if reduction == "sum":
        return 1
    raise ValueError(f"unknown reduction {reduction!r}")


def all_reduce_grads(params: Iterable[torch.Tensor], reduction: str = "mean") -> None:
    """Every rank's gradients (.grad of `params`, those that have one) made
    the global batch's, in one flat all-reduce: averaged for a mean-reduced
    loss over equal shares, summed for a sum-reduced one."""
    if get_world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat /= _mean_divisor(reduction)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def reduce_value(t: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """A metric of the local batch (any shape, no graph) made the global
    batch's: averaged over the ranks for 'mean', summed for 'sum'."""
    if get_world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / _mean_divisor(reduction)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the ranks of x, on every rank. The cotangent of x is the
    sum over the ranks of y's cotangents: the same all-reduce, itself
    differentiable."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g.contiguous())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of x over the ranks (x itself at world size 1).
    Every rank must call it, in the same order, in the forward and (through
    autograd) in the backward."""
    return _AllReduceSum.apply(x) if get_world_size() > 1 else x


def gather_rows(local: torch.Tensor, n: int, rows: slice) -> torch.Tensor:
    """The (n, ...) stack whose `rows` this rank computed as `local`, the
    rest from the other ranks, on every rank: an all_reduce of zero-padded
    stacks (exact: every entry is one rank's value plus zeros)."""
    if get_world_size() == 1:
        return local
    full = local.new_zeros((n,) + tuple(local.shape[1:]))
    full[rows] = local
    dist.all_reduce(full)
    return full


def gather_objects(obj: Any) -> Optional[List[Any]]:
    """Each rank's picklable `obj`, in rank order, on rank 0; None elsewhere."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out if is_primary() else None
