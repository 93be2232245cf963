"""The trainable models (port of dynavsr_tpu/models/video_base_model.py:
VideoBaseModel, MetaModel, DownscalerModel, trainer_config_from_opt and
create_model).

`VideoBaseModel(opt, device)` builds `network_G` with define_G on the card
(unless the caller asks for the CPU) and loads `path.pretrain_model_G`
through train/checkpoint.load_pretrained (honouring `path.strict_load`).
It hands out the forwards evaluation needs (numpy windows in, numpy SR
out, no autograd, the net in eval mode for the call). With
`opt['is_train']` it also trains, with the reference's surface:
feed_data / optimize_parameters / test / get_current_log /
get_current_visuals / get_current_learning_rate / save /
save_training_state / resume_training. update_learning_rate is a no-op,
as in JAX: the train step sets each update's lr from the schedule.

MetaModel meta-trains the VSR net (train/meta.py) on batches of SLR / LR
windows and their LR / HR centres, both forwards mod-padded as
`make_model_apply` pads them; its optimizer holds the net's BatchNorm
running statistics beside its parameters, as the JAX package's meta step
differentiates and steps them. DownscalerModel trains MFDN / SFDN with the
LR windows as input and the SLR windows as target.

Under torch.distributed (one process a card, parallel/mesh.py) the net is
rank 0's at construction and after a resume (broadcast: JAX's
`replicate`), every rank trains on its share of the global batch, and rank
0 alone writes `.pth` / `.state` files while the others wait at a barrier.
`n_devices`, which caps JAX's mesh, must equal the world size the launcher
made when it is set.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os.path as osp
from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from dynavsr_tpu_torch.adapt.adaptation import seq_forward
from dynavsr_tpu_torch.device import resolve_device
from dynavsr_tpu_torch.eval.tiled import make_tiled_apply
from dynavsr_tpu_torch.models.networks import define_G
from dynavsr_tpu_torch.models.padding import arch_mod, make_model_apply
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train import checkpoint
from dynavsr_tpu_torch.train.checkpoint import load_network, load_pretrained, save_network
from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step, meta_variables
from dynavsr_tpu_torch.train.trainer import (
    TrainerConfig,
    make_optimizer,
    make_schedule,
    make_train_step,
)
from dynavsr_tpu_torch.utils.observability import span

__all__ = ["VideoBaseModel", "MetaModel", "DownscalerModel", "create_model",
           "trainer_config_from_opt", "check_n_devices"]


def trainer_config_from_opt(opt: Mapping) -> TrainerConfig:
    """The `train` block's fields (the JAX package's names and defaults).
    `restarts` is not read, as in JAX: the periods set the restarts."""
    t = opt.get("train") or {}
    return TrainerConfig(
        lr=t.get("lr_G") or 4e-4,
        beta1=t.get("beta1") or 0.9,
        beta2=t.get("beta2") or 0.99,
        scheme=t.get("lr_scheme") or "CosineAnnealingLR_Restart",
        periods=tuple(t.get("T_period") or (150000,) * 4),
        restart_weights=tuple(t.get("restart_weights") or (1, 0.5, 0.5, 0.5)),
        eta_min=t.get("eta_min") or 1e-7,
        milestones=tuple(t.get("lr_steps") or ()),
        gamma=t.get("lr_gamma") or 0.5,
        warmup_iter=t.get("warmup_iter") if t.get("warmup_iter") is not None else -1,
        pixel_weight=t.get("pixel_weight") or 1.0,
        criterion=t.get("pixel_criterion") or "cb",
        reduction=t.get("pixel_criterion_reduction") or "mean",
        weight_decay=float(t.get("weight_decay_G") or t.get("weight_decay") or 0.0),
        grad_clip=float(t["grad_clip"]) if t.get("grad_clip") else None,
    )


class VideoBaseModel:
    """The VSR net of a config on `device`; with opt['is_train'], also its
    optimizer and the count of updates made (`step`)."""

    def __init__(self, opt: Mapping, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        ev = opt.get("eval") or {}
        # eval.tile: an int or [th, tw]; eval.tile_overlap (eval/tiled.py).
        self.tile, self.tile_overlap = ev.get("tile"), ev.get("tile_overlap")
        self.scale = opt.get("scale", 4)
        self.infer_chunk = int(ev.get("infer_chunk") or 8)
        check_n_devices(opt)
        self.netG = define_G(opt, self.device).eval()
        path = opt.get("path") or {}
        load_pretrained(self.netG, path.get("pretrain_model_G"),
                        strict=path.get("strict_load", True) is not False)
        mesh.replicate(self.netG)
        self.is_train = bool(opt.get("is_train"))
        self.cfg = trainer_config_from_opt(opt)
        self.sched = make_schedule(self.cfg)
        self.step = 0
        self.log: Dict[str, float] = {}
        self._batch: Dict[str, torch.Tensor] = {}
        self._fake_H: Optional[torch.Tensor] = None
        self.optimizer = make_optimizer(self.cfg, self._trained()) if self.is_train else None
        self._train_step = None

    def _trained(self):
        """The tensors the optimizer steps: the net's parameters."""
        return self.netG.parameters()

    @contextlib.contextmanager
    def _eval_mode(self):
        """The net in eval mode for the block, then back in the mode it had."""
        was_training = self.netG.training
        try:
            yield self.netG.eval()
        finally:
            self.netG.train(was_training)

    # ------------------------------------------------------------ training
    def feed_data(self, data: Mapping, need_GT: bool = True) -> None:
        """A loader batch (numpy NHWC) -> float32 tensors on the device."""
        self._batch = {"LQs": torch.as_tensor(np.asarray(data["LQs"], np.float32),
                                              device=self.device)}
        if need_GT and "GT" in data:
            self._batch["GT"] = torch.as_tensor(np.asarray(data["GT"], np.float32),
                                                device=self.device)

    def optimize_parameters(self, step: Optional[int] = None) -> None:
        """One update on the fed batch. The lr comes from the model's own
        count of updates (`self.step`), which resume_training restores;
        `step` (the loop's iteration) is accepted for the reference's
        surface."""
        if self.optimizer is None:
            raise RuntimeError("the model was not built for training (opt['is_train'])")
        if self._train_step is None:
            self._train_step = make_train_step(self.netG, self.cfg, self.optimizer)
        metrics = self._train_step(self._batch, self.step)
        self.step += 1
        self.log = {k: float(v) for k, v in metrics.items()}
        off = self.log.get("dcn_offset_absmean", 0.0)
        if off > 100.0:  # the reference DCN_sep's guard
            logging.getLogger("base").warning(
                "Offset abs mean is %.1f, larger than 100 — DCN offsets may be diverging.", off)

    def test(self) -> None:
        """The fed windows' SR, as they are (no padding), in eval mode."""
        with torch.no_grad(), self._eval_mode() as net:
            self._fake_H = net(self._batch["LQs"])

    def get_current_log(self) -> Dict[str, float]:
        return dict(self.log)

    def get_current_visuals(self, need_GT: bool = True) -> Dict[str, np.ndarray]:
        out = {"LQ": self._batch["LQs"][0].cpu().numpy(),
               "restored": self._fake_H[0].float().cpu().numpy()}
        if need_GT and "GT" in self._batch:
            out["GT"] = self._batch["GT"][0].cpu().numpy()
        return out

    def get_current_learning_rate(self) -> float:
        return float(self.sched(self.step))

    def update_learning_rate(self, step: int, warmup_iter: int = -1) -> None:
        """No-op: the train step sets every update's lr from the schedule."""

    def save(self, it) -> str:
        """<models>/<it>_G.pth, written by rank 0."""
        return _on_primary(lambda: save_network(self.opt["path"]["models"], int(it), self.netG),
                           osp.join(osp.abspath(self.opt["path"]["models"]), f"{int(it)}_G.pth"))

    def save_training_state(self, epoch: int, it: int) -> str:
        """<training_state>/<it>.state, written by rank 0."""
        return _on_primary(
            lambda: checkpoint.save_training_state(self.opt["path"]["training_state"], epoch,
                                                   int(it), self.optimizer),
            osp.join(osp.abspath(self.opt["path"]["training_state"]), f"{int(it)}.state"))

    def resume_training(self, state_path: str) -> int:
        """Restore the optimizer and the update count from a .state file and
        the net from <models>/<iter>_G.pth; returns the saved epoch."""
        epoch, it = checkpoint.resume_training(state_path, self.optimizer)
        load_network(osp.join(self.opt["path"]["models"], f"{it}_G.pth"), self.netG)
        mesh.replicate(self.netG)
        self.step = it
        return epoch

    # ---------------------------------------------------------- evaluation
    def make_infer_fn(self) -> Callable[[np.ndarray], np.ndarray]:
        """(F, N, h, w, 3) windows -> (F, H, W, 3) SR, with the net's input
        convention (models/padding.make_model_apply: EDVR's mod-4 padding,
        TOF's bicubic pre-upscale); with eval.tile, as overlapping tiles of
        the frame (eval/tiled.make_tiled_apply), all tiles in one call."""
        apply = make_model_apply(self.netG.arch, self.scale)
        if self.tile:
            apply = make_tiled_apply(apply, self.tile, self.tile_overlap, self.scale)

        def infer(windows: np.ndarray) -> np.ndarray:
            with torch.no_grad(), self._eval_mode() as net:
                x = torch.as_tensor(np.asarray(windows), device=self.device)
                return apply(net, x).cpu().numpy()

        return infer

    def make_seq_infer_fn(self) -> Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]]:
        """Sequence-mode forward (eval.seq): (frames (T, h, w, 3), win (F, N))
        -> (F, H, W, 3), each frame's pyramid extracted once and shared by
        the windows that hold it, `eval.infer_chunk` windows fused at a
        time (exact against the window path). The frames are reflect-padded
        to a multiple of 4 once, as the window path pads each window. None
        for a net without a pyramid-split forward (TOF, DUF), and under
        eval.tile (the tiled forward takes window batches)."""
        if self.netG.arch != "EDVR" or self.tile:
            return None
        mod = arch_mod("EDVR")

        def infer(frames: np.ndarray, win: np.ndarray) -> np.ndarray:
            h, w = frames.shape[1:3]
            ph, pw = (-h) % mod, (-w) % mod
            if ph or pw:
                frames = np.pad(frames, [(0, 0), (0, ph), (0, pw), (0, 0)], mode="reflect")
            with torch.no_grad(), self._eval_mode() as net:
                sr = seq_forward(net, torch.as_tensor(frames, device=self.device),
                                 torch.as_tensor(win, dtype=torch.long, device=self.device),
                                 self.infer_chunk)
            return sr[:, : h * self.scale, : w * self.scale].cpu().numpy()

        return infer


def check_n_devices(opt: Mapping) -> None:
    """`n_devices` caps JAX's mesh; in the port the launcher fixes the world
    size, so a set n_devices must equal it."""
    nd = opt.get("n_devices")
    if nd and int(nd) != mesh.get_world_size():
        raise ValueError(f"n_devices is {nd}, but the launcher started "
                         f"{mesh.get_world_size()} rank(s)")


def _on_primary(write: Callable[[], str], path: str) -> str:
    """write() on rank 0, the other ranks waiting at a barrier; the path."""
    if mesh.is_primary():
        path = write()
    mesh.barrier()
    return path


def _to_device(data: Mapping, keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(data[k], dtype=torch.float32, device=device)
            for k in keys if k in data}


class MetaModel(VideoBaseModel):
    """DynaVSR meta-trainer (Algorithm 1) with VideoBaseModel's surface.
    The `train` block's maml_lr_alpha, maml_adapt_iter, first_order and
    pixel_weight set MetaConfig; the fed batch carries SLR, LR, LR_center
    and HR_center (cli/train.synthesize_meta_batch).

    EDVR, TOF and DUF meta-train to second order on the kernels, in fp32
    or bf16 (an EDVR net in bf16, as EDVR-L's configs set it, runs K1-K3
    and K8-K10 in bf16; a DUF net in bf16 runs K6 / K7 on its bf16 filters). The
    optimizer steps meta_variables(netG): the parameters and the BatchNorm
    running statistics (TOF, DUF), whose Adam moments the `.state` file
    keeps."""

    def __init__(self, opt: Mapping, device=None):
        super().__init__(opt, device)
        t = opt.get("train") or {}
        self.meta_cfg = MetaConfig(
            inner_lr=t.get("maml_lr_alpha") or 1e-5,
            inner_steps=t.get("maml_adapt_iter") or 1,
            first_order=bool(t.get("first_order", False)),
            pixel_weight=t.get("pixel_weight") or 1.0)
        self._meta_step = None

    def _trained(self):
        """The parameters and the BatchNorm running statistics (the JAX
        package's meta step steps its whole variables dict)."""
        return list(meta_variables(self.netG).values())

    def feed_data(self, data: Mapping, need_GT: bool = True) -> None:
        """Tensors or numpy arrays (NHWC) -> float32 tensors on the device."""
        with span("meta.feed"):
            self._batch = _to_device(data, ("SLR", "LR", "LR_center", "HR_center", "LQs"),
                                     self.device)

    def optimize_parameters(self, step: Optional[int] = None) -> None:
        if self.optimizer is None:
            raise RuntimeError("the model was not built for training (opt['is_train'])")
        if self._meta_step is None:
            self._meta_step = make_meta_train_step(
                self.netG, self.meta_cfg, self.optimizer, self.sched, self.cfg.grad_clip,
                apply_fn=make_model_apply(self.netG.arch, self.scale))
        with span("meta.step"):
            metrics = self._meta_step(self._batch, self.step)
            self.step += 1
            with span("meta.log"):
                self.log = {k: float(v) for k, v in metrics.items()}


class DownscalerModel(VideoBaseModel):
    """MFDN / SFDN trainer: the fed batch's LR windows are the input and
    its SLR windows the target (cli/train.synthesize_downscaler_batch:
    LR = (HR * k) ds, SLR = (LR * k) ds). An MFDN block without `nframes`
    takes the training windows' N_frames (JAX's MFDN infers its input
    channels from the batch)."""

    def __init__(self, opt: Mapping, device=None):
        net = opt.get("network_G") or {}
        frames = ((opt.get("datasets") or {}).get("train") or {}).get("N_frames")
        if net.get("which_model_G") == "MFDN" and net.get("nframes") is None and frames:
            opt = copy.copy(opt)
            opt["network_G"] = {**net, "nframes": frames}
        super().__init__(opt, device)

    def feed_data(self, data: Mapping, need_GT: bool = True) -> None:
        self._batch = {
            "LQs": torch.as_tensor(data["LR"] if "LR" in data else data["LQs"],
                                   dtype=torch.float32, device=self.device),
            "GT": torch.as_tensor(data["SLR"] if "SLR" in data else data["GT"],
                                  dtype=torch.float32, device=self.device)}


def create_model(opt: Mapping, device=None) -> VideoBaseModel:
    """`opt['model']` dispatch (default video_base)."""
    which = opt.get("model") or "video_base"
    if which in ("video_base", "VideoSR_base", "sr"):
        return VideoBaseModel(opt, device)
    if which in ("video_meta", "meta", "dynavsr"):
        return MetaModel(opt, device)
    if which in ("downscaler", "estimator"):
        return DownscalerModel(opt, device)
    raise NotImplementedError(f"Model [{which}] not recognized.")
