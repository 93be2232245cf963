"""A multi-rank dry run of the port's parallel paths (counterpart of the
JAX package's `__graft_entry__.dryrun_multichip`).

    python -m dynavsr_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks on this host (a torch.distributed group on a free local
port: NCCL with one card a rank, gloo on the CPU or where ranks share a
card) and takes, at JAX's tiny sizes (EDVR nf 8, 3 frames, Gd 2, 1 + 1
blocks; one example or clip a rank, inputs from a seed):
  1. one supervised train step on a global batch of N,
  2. one second-order meta step,
  3. one clip-parallel adapt-and-infer of N clips,
  4. one tiled eval whose tile batch is shared out over the ranks,
  5. one clip-parallel sequence-mode adapt-and-infer.
Each step checks its shapes, finite values and that every rank holds the
same weights and results; it prints `dryrun(N) OK` and exits 0, or raises.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.multiprocessing as mp

from dynavsr_tpu_torch.adapt.adaptation import (
    AdaptConfig,
    make_adapt_and_infer_batched,
    make_adapt_and_infer_seq_batched,
)
from dynavsr_tpu_torch.data.windows import all_windows
from dynavsr_tpu_torch.eval.tiled import make_tiled_apply
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.parallel import mesh
from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step, meta_variables
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_train_step

__all__ = ["dryrun"]


def _same_on_every_rank(what: str, t: torch.Tensor) -> None:
    """Raise unless every rank holds t bitwise (gathered on rank 0)."""
    got = mesh.gather_objects(t.detach().cpu().numpy())
    if got is not None and not all(np.array_equal(got[0], g) for g in got[1:]):
        raise AssertionError(f"{what} differs between the ranks")


def _flat(model: torch.nn.Module) -> torch.Tensor:
    return torch.cat([t.detach().flatten() for t in meta_variables(model).values()])


def _steps(device: torch.device) -> None:
    n = mesh.get_world_size()
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    torch.manual_seed(0)
    model = mesh.replicate(EDVR(nf=8, nframes=3, groups=2, front_RBs=1, back_RBs=1).to(device))
    rows = mesh.batch_rows(n)
    x, gt = rand(n, 3, 8, 8, 3), rand(n, 32, 32, 3)

    # 1) supervised step on this rank's share of the global batch.
    cfg = TrainerConfig(lr=1e-4, scheme="constant")
    step = make_train_step(model, cfg, make_optimizer(cfg, model.parameters()))
    metrics = step({"LQs": x[rows], "GT": gt[rows]}, 0)
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    _same_on_every_rank("the weights after the train step", _flat(model))

    # 2) second-order meta step (the SLR keeps EDVR's mod-4 pyramid).
    apply = make_model_apply("EDVR", 4)
    meta = {"SLR": rand(n, 3, 4, 4, 3), "LR": x, "LR_center": rand(n, 16, 16, 3),
            "HR_center": gt}
    mcfg = MetaConfig(inner_lr=1e-6, inner_steps=1)
    opt = make_optimizer(cfg, list(meta_variables(model).values()))
    mstep = make_meta_train_step(model, mcfg, opt, lambda c: cfg.lr, apply_fn=apply)
    metrics = mstep({k: v[rows] for k, v in meta.items()}, 1)
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
    _same_on_every_rank("the weights after the meta step", _flat(model))

    # 3) clip-parallel adapt + infer: n clips, each rank its share.
    acfg = AdaptConfig(n_steps=2, lr=1e-6)
    slr_w, lr_c = rand(n, 2, 3, 4, 4, 3), rand(n, 2, 16, 16, 3)
    sr, losses = make_adapt_and_infer_batched(acfg, apply_fn=apply)(
        model, slr_w, lr_c, rand(n, 4, 3, 8, 8, 3))
    assert sr.shape == (n, 4, 32, 32, 3) and losses.shape == (n, 2), (sr.shape, losses.shape)
    assert bool(torch.isfinite(sr).all())
    _same_on_every_rank("the clip-parallel SR", sr)

    # 4) tiled eval, the tile batch shared out over the ranks.
    def rank_apply(net, v):
        m = v.shape[0]
        v = torch.cat([v, v[-1:].expand(-m % n, *v.shape[1:])]) if m % n else v
        share = mesh.batch_rows(v.shape[0])
        with torch.no_grad():
            out = apply(net, v[share])
        return mesh.gather_rows(out, v.shape[0], share)[:m]

    tiled = make_tiled_apply(rank_apply, (8, 8), 2, 4)
    sr_t = tiled(model, rand(4, 3, 12, 16, 3))  # 6 tiles x 4 windows
    assert sr_t.shape == (4, 48, 64, 3), sr_t.shape
    _same_on_every_rank("the tiled SR", sr_t)

    # 5) clip-parallel sequence mode: per-clip frames and window tables.
    win = torch.as_tensor(all_windows(4, 3, "reflection"), dtype=torch.long, device=device)
    sr_s, _ = make_adapt_and_infer_seq_batched(acfg, apply_fn=apply)(
        model, slr_w, lr_c, rand(n, 4, 8, 8, 3), win.expand(n, 4, 3))
    assert sr_s.shape == (n, 4, 32, 32, 3), sr_s.shape
    _same_on_every_rank("the clip-parallel sequence-mode SR", sr_s)


def _rank(r: int, world: int, port: int, device: str) -> None:
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if device == "cuda" else 0
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(r % cards if cards else 0))
    dev = mesh.init_dist("pytorch", device,
                         backend="gloo" if device == "cpu" or world > cards else None)
    try:
        _steps(dev)
        mesh.barrier()
    finally:
        torch.distributed.destroy_process_group()


def dryrun(n: int, device: str = "cuda") -> None:
    """The five steps on n spawned ranks; raises if a rank fails."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    mp.spawn(_rank, args=(n, mesh.free_port(), device), nprocs=n, join=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks to spawn")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun(args.n, args.device)
    print(f"dryrun({args.n}) OK")


if __name__ == "__main__":
    main()
