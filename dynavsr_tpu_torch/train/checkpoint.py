"""Checkpoints and training state (port of dynavsr_tpu/train/checkpoint.py,
plus the loader the entry points share).

The port's own network format is a plain state_dict under the reference's
keys, written with `torch.save` as `<models_dir>/<iter>_<label>.pth`. A
reference `.pth` / `.pt` has the same keys (after the DDP `module.` prefix
is stripped), so `load_pretrained` reads both the same way. The training
state is `<state_dir>/<iter>.state`: the epoch, the iteration and the
optimizer's state_dict (the lr schedule is a function of the iteration, so
nothing else is needed to resume). The JAX package's orbax checkpoint
directories are not read: that needs orbax and tensorstore, which the port
does not import; tools/orbax_to_pth.py (outside the package) converts them
to `.pth` files.
"""

from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Dict, Mapping, Optional, Tuple

import torch

from dynavsr_tpu_torch.convert.from_jax import strip_module_prefix

__all__ = ["save_network", "load_network", "load_pretrained", "latest_checkpoint_iter",
           "save_training_state", "resume_training"]

logger = logging.getLogger("dynavsr_tpu_torch")


def save_network(models_dir: str, it: int, model: torch.nn.Module, label: str = "G") -> str:
    """Write model's state_dict (on the host) to <models_dir>/<it>_<label>.pth."""
    os.makedirs(models_dir, exist_ok=True)
    path = osp.join(osp.abspath(models_dir), f"{it}_{label}.pth")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)
    return path


def _pick(state: Mapping[str, torch.Tensor], model: torch.nn.Module,
          strict: bool) -> Dict[str, torch.Tensor]:
    """strict: the state as it is (load_state_dict checks keys and shapes).
    Otherwise only the entries whose key and shape the model has; the rest
    of the model keeps its values (the JAX package's strict=False)."""
    if strict:
        return dict(state)
    own = model.state_dict()
    return {k: v for k, v in state.items() if k in own and v.shape == own[k].shape}


def load_network(path: str, model: torch.nn.Module, strict: bool = True) -> torch.nn.Module:
    """Load a `.pth` / `.pt` state_dict (the port's own, or a reference one:
    a {'state_dict': ...} wrapper and `module.` prefixes are undone) into
    `model`, in place, and return it."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = strip_module_prefix(state.get("state_dict", state))
    model.load_state_dict(_pick(state, model, strict), strict=strict)
    return model


def load_pretrained(model: torch.nn.Module, path: Optional[str], strict: bool = True) -> None:
    """The entry points' loader for `path.pretrain_model_*`: nothing to do
    without a path (the model keeps its initial weights, with a warning); a
    `.pth` / `.pt` file loads through load_network; an orbax checkpoint
    directory (the JAX package's `.ckpt` / `<iter>_G`) raises, naming the
    converter tools/orbax_to_pth.py."""
    if not path:
        logger.warning("no checkpoint for %s: using its initial weights", type(model).__name__)
        return
    if path.endswith((".pth", ".pt")):
        load_network(path, model, strict)
        return
    if osp.isdir(path) or path.endswith(".ckpt"):
        raise NotImplementedError(
            f"{path}: a JAX orbax checkpoint directory. Reading it needs orbax and "
            "tensorstore, which the port does not import; convert it to a .pth with "
            "tools/orbax_to_pth.py (python tools/orbax_to_pth.py CKPT OUT.pth [-opt CONFIG]: "
            "it restores with the JAX package and maps with convert/from_jax.py) and load "
            "that (the port reads no orbax checkpoints itself)")
    raise ValueError(f"{path}: not a .pth / .pt checkpoint")


def latest_checkpoint_iter(models_dir: str, label: str = "G") -> Optional[int]:
    """The largest <it> with a saved <it>_<label>.pth, or None."""
    if not osp.isdir(models_dir):
        return None
    suffix = f"_{label}.pth"
    its = [int(name[: -len(suffix)]) for name in os.listdir(models_dir)
           if name.endswith(suffix) and name[: -len(suffix)].isdigit()]
    return max(its) if its else None


def save_training_state(state_dir: str, epoch: int, it: int,
                        optimizer: torch.optim.Optimizer) -> str:
    """Write {epoch, iter, optimizer state_dict} to <state_dir>/<it>.state."""
    os.makedirs(state_dir, exist_ok=True)
    path = osp.join(osp.abspath(state_dir), f"{it}.state")
    torch.save({"epoch": int(epoch), "iter": int(it), "optimizer": optimizer.state_dict()}, path)
    return path


def resume_training(path: str, optimizer: torch.optim.Optimizer) -> Tuple[int, int]:
    """Load a .state file's optimizer state into `optimizer` (its tensors
    mapped to the device of the optimizer's parameters) -> (epoch, iter)."""
    device = next(p.device for g in optimizer.param_groups for p in g["params"])
    state = torch.load(path, map_location=device, weights_only=True)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"]), int(state["iter"])
