"""Rank functions of the port's multi-rank CPU tests
(tests/test_torch_port_parallel*.py).

`spawn(fn, world, *args)` runs fn(*args) on `world` spawned processes that
form a gloo group on a free local port (parallel/mesh.init_dist with
torchrun's environment variables, one intra-op thread a rank) and returns
each rank's result, in rank order. The spawned processes import this module
by name, so it imports torch and the port only (no jax).
"""

import os
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from dynavsr_tpu_torch.adapt.adaptation import (
    AdaptConfig,
    make_adapt_and_infer_batched,
    make_adapt_and_infer_seq_batched,
)
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply, make_mutable_model_apply
from dynavsr_tpu_torch.models.tof import TOFlow
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train import meta, trainer
from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step, meta_variables
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_train_step

EDVR_CFG = dict(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1)


def _entry(rank, world, port, fn, args, out_dir):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK="0")
    mesh.init_dist("pytorch", "cpu")
    try:
        torch.save(fn(*args), os.path.join(out_dir, f"{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn, world, *args):
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_entry, args=(world, mesh.free_port(), fn, args, d), nprocs=world, join=True)
        return [torch.load(os.path.join(d, f"{r}.pt"), weights_only=False)
                for r in range(world)]


def net(arch, state=None):
    """The tiny EDVR or a 3-frame TOFlow, with `state` loaded when given."""
    model = EDVR(**EDVR_CFG) if arch == "EDVR" else TOFlow(nframes=3)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.eval()


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ------------------------------------------------------------ clip-parallel
def clip_parallel(cases):
    """cases: name -> dict(arch, state, seq, cfg (AdaptConfig kwargs),
    stacks (numpy, the batched function's inputs after the model)). Returns
    name -> (sr, losses) as numpy, the whole stacks on every rank."""
    out = {}
    for name, c in cases.items():
        arch = c["arch"]
        build = make_adapt_and_infer_seq_batched if c["seq"] else make_adapt_and_infer_batched
        mutable = make_mutable_model_apply(arch, 4) if arch == "TOF" else None
        run = build(AdaptConfig(**c["cfg"]), make_model_apply(arch, 4), mutable)
        stacks = [_t(s) for s in c["stacks"]]
        if c["seq"]:
            stacks[-1] = stacks[-1].long()
        sr, losses = run(net(arch, c["state"]), *stacks)
        out[name] = (sr.numpy(), losses.numpy())
    return out


# -------------------------------------------------------------- train steps
def _recording(fn, log):
    """fn (trainer / meta apply_update) that first logs the gradients it is
    handed, flattened: the all-reduced ones."""
    def call(optimizer, params, *args):
        params = list(params)
        log.append(torch.cat([p.grad.flatten() for p in params]).clone())
        return fn(optimizer, params, *args)
    return call


def train_steps(arch, state, train_cfg, batches):
    """len(batches) supervised updates of `arch` on this rank's rows of each
    global batch (train/trainer.make_train_step). Returns (metrics per
    update, state_dict after, gradients per update)."""
    model = mesh.replicate(net(arch, state))
    cfg = TrainerConfig(**train_cfg)
    step = make_train_step(model, cfg, make_optimizer(cfg, model.parameters()))
    grads, orig = [], trainer.apply_update
    trainer.apply_update = _recording(orig, grads)
    metrics = []
    try:
        for i, b in enumerate(batches):
            rows = mesh.batch_rows(b["LQs"].shape[0])
            metrics.append({k: float(v) for k, v in step(
                {k: _t(v[rows]) for k, v in b.items()}, i).items()})
    finally:
        trainer.apply_update = orig
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}, grads


def meta_step(state, meta_cfg, lr, batch):
    """One second-order meta update of the tiny EDVR (train/meta.py) on
    this rank's rows of `batch`. Returns (metrics, the fast weights the
    step took, flattened, the gradient handed to the update, state_dict
    after)."""
    model = mesh.replicate(net("EDVR", state))
    opt = torch.optim.Adam(list(meta_variables(model).values()), lr=lr)
    step = make_meta_train_step(model, MetaConfig(**meta_cfg), opt, lambda c: lr,
                                apply_fn=make_model_apply("EDVR", 4))
    grads, fast = [], []
    orig_update, orig_adapted = meta.apply_update, meta.adapted_params

    def adapted(*args, **kwargs):
        params, loss = orig_adapted(*args, **kwargs)
        fast.append(torch.cat([p.detach().flatten() for p in params.values()]).clone())
        return params, loss

    meta.apply_update, meta.adapted_params = _recording(orig_update, grads), adapted
    try:
        rows = mesh.batch_rows(batch["SLR"].shape[0])
        metrics = {k: float(v) for k, v in step({k: _t(v[rows]) for k, v in batch.items()},
                                                0).items()}
    finally:
        meta.apply_update, meta.adapted_params = orig_update, orig_adapted
    return metrics, fast[0], grads[0], {k: v.clone() for k, v in model.state_dict().items()}


def train_and_meta(train_cases, meta_case):
    """Every train_steps case, then meta_step, in one group of ranks."""
    return ({name: train_steps(**c) for name, c in train_cases.items()},
            meta_step(**meta_case))
