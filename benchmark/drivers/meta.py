"""Driver of DynaVSR's meta-training through the path the training CLI
takes: create_model -> MetaModel, feed_data and optimize_parameters on
batches from cli/train.synthesize_meta_batch with the frozen MFDN in the
loop (network_E), one update after another.

Traffic: a pool of HR clips made from the seed in host memory; each
update crops `batch_size` 5-frame windows at random GT_size^2 positions
(drawn from the seed) and hands them to the synthesis. The LMDB loader is
bypassed. The unit is one update of `batch_size` samples.

Correctness (the training rule): set-up builds one MetaModel and drives
it through its first `check_steps` updates, the same calls as the
window's, on rows that all differ; the reference follows those steps from
the same weights and HR windows. Compared: each step's outer and inner
loss, the synthesized first batch (LR and SLR), the first meta gradient
as the optimizer holds it (Adam's first moment over 1 - beta1, by the
worst leaf's norm), and each leaf's change over the steps (by the worst
leaf's norm, leaves whose reference gradient is nought to rounding left
out).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.reference import meta as ref_meta
from benchmark.reference import nets


def _port():
    from dynavsr_tpu_torch.cli import test_dynavsr
    from dynavsr_tpu_torch.cli import train as train_cli
    from dynavsr_tpu_torch.models.video_base_model import create_model
    from dynavsr_tpu_torch.ops import dcn
    from dynavsr_tpu_torch.train.meta import meta_variables
    return SimpleNamespace(test_dynavsr=test_dynavsr, train_cli=train_cli,
                           create_model=create_model, dcn=dcn, meta_variables=meta_variables)


def synth_generator(seed: int, step: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((inputs.stream_seed(seed, "traffic") * 1000003 + step) % (2 ** 63))
    return g


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    gen = inputs.generator(seed, "traffic", device)
    c = traffic["pool"]
    return np.stack([inputs.sinusoids(gen, c["frames"], c["hr_h"], c["hr_w"], c["components"],
                                      c["freq"], c["speed"]).cpu().numpy()
                     for _ in range(c["clips"])])


def crops(pool: np.ndarray, rng: np.random.Generator, batch: int, n: int, size: int):
    """`batch` n-frame windows of size^2 at random clips, frames and
    positions."""
    clips, t, h, w, _ = pool.shape
    out = []
    for _ in range(batch):
        ci, f0 = rng.integers(clips), rng.integers(t - n + 1)
        y, x = rng.integers(h - size + 1), rng.integers(w - size + 1)
        out.append(pool[ci, f0: f0 + n, y: y + size, x: x + size])
    return np.ascontiguousarray(np.stack(out))


def _opt(cfg: dict) -> dict:
    m = cfg["meta"]
    return {"model": "video_meta", "scale": cfg["scale"], "is_train": True,
            "network_G": {"which_model_G": "EDVR", **cfg["network_G"]},
            "network_E": {"which_model_G": "MFDN", **cfg["network_E"]},
            "datasets": {"train": {"N_frames": m["N_frames"], "GT_size": m["GT_size"],
                                   "batch_size": m["batch_size"]}},
            "path": {"pretrain_model_G": None, "strict_load": True},
            "train": {k: m[k] for k in ("lr_G", "lr_scheme", "beta1", "beta2", "maml_lr_alpha",
                                        "maml_adapt_iter", "first_order", "pixel_criterion",
                                        "pixel_weight")}}


def setup(cfg, traffic, seed, device, tracer):
    port = _port()
    m = cfg["meta"]
    model = port.create_model(_opt(cfg), device)
    est = port.test_dynavsr.build_estimator({"which_model_G": "MFDN", **cfg["network_E"]},
                                            cfg["scale"], m["N_frames"], device)
    p_vsr = inputs.make_params(inputs.vsr_spec(cfg), seed, "weights_vsr", device)
    p_est = inputs.make_params(inputs.est_spec(cfg), seed, "weights_est", device)
    model.netG.load_state_dict(p_vsr, strict=True)
    est.load_state_dict(p_est, strict=True)
    est.requires_grad_(False)

    def estimator(lr):
        with torch.no_grad():
            return est(lr)

    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device, port=port, model=model,
                         estimator=estimator, p_vsr=p_vsr, p_est=p_est, units=0, step=0,
                         seed=seed, pool=make_pool(traffic, seed, device),
                         rng=np.random.default_rng(inputs.stream_seed(seed, "traffic")))
    tracer.wrap(port.train_cli, "synthesize_meta_batch", "synth")
    tracer.record_dcn(port.dcn)
    names = list(port.meta_variables(model.netG))
    st.hr, st.batches, st.losses = [], [], []
    for i in range(int(traffic["check_steps"])):  # the first steps, the reference's too
        batch = update(st)
        st.losses.append((model.log["l_outer"], model.log["l_inner"]))
        if i == 0:
            st.batches.append({k: batch[k].detach().clone() for k in ("LR", "SLR")})
            b1 = model.optimizer.param_groups[0]["betas"][0]
            held = port.meta_variables(model.netG)
            st.first_grad = {k: model.optimizer.state[held[k]]["exp_avg"].detach() / (1 - b1)
                             for k in names}
    st.after = {k: v.detach().clone() for k, v in port.meta_variables(model.netG).items()}
    return st


def update(st) -> dict:
    """One meta update: crop, synthesize (MFDN in the loop), feed, step."""
    m = st.cfg["meta"]
    hr = crops(st.pool, st.rng, m["batch_size"], m["N_frames"], m["GT_size"])
    if len(st.hr) < int(st.traffic["check_steps"]):
        st.hr.append(hr)
    batch = st.port.train_cli.synthesize_meta_batch(
        synth_generator(st.seed, st.step, st.device), hr, st.cfg["scale"], st.estimator)
    st.model.feed_data(batch)
    st.model.optimize_parameters(st.step)
    st.step += 1
    return batch


def window(st, seconds: float) -> dict:
    t0 = time.perf_counter()
    n = 0
    while True:
        update(st)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    st.units = n
    return {"samples_per_s": n * st.cfg["meta"]["batch_size"] / (time.perf_counter() - t0)}


def traced(st, tracer) -> None:
    n = int(st.traffic["traced_units"])
    for _ in range(n):
        update(st)
        tracer.count("units")
    st.units = n
    tracer.trace.info["dtype"] = "bf16" if st.cfg["network_G"].get("dtype") == "bf16" else "fp32"


def reference_run(st, q) -> dict:
    """The reference's first steps on the set-up's HR windows."""
    batches = []
    for i, hr in enumerate(st.hr):
        g = synth_generator(st.seed, i, st.device)
        batches.append(ref_meta.synthesize(g, torch.as_tensor(hr, device=st.device),
                                           st.cfg["scale"], st.p_est, q))
    out = ref_meta.train(st.p_vsr, batches, st.cfg["network_G"], st.cfg["meta"], q)
    out["batch0"] = {k: batches[0][k] for k in ("LR", "SLR")}
    return out


def numbers(losses, batch0, first_grad, after, ref, p0) -> list:
    ch = compare.change_numbers(after, ref["params"], p0, ref["first_grads"])
    return [("outer_loss_rel", compare.rel_gap([a for a, _ in losses], ref["outer"])),
            ("inner_loss_rel", compare.rel_gap([b for _, b in losses], ref["inner"])),
            ("batch_max_abs", compare.max_abs(batch0, ref["batch0"])),
            ("first_grad_gap", compare.leaf_norm_gap(first_grad, ref["first_grads"])),
            ("weight_change_gap", ch["weight_change_gap"]),
            ("weight_change_median", ch["weight_change_median"]),
            ("_worst_leaves", ch["_worst"])]


def check(st, seed) -> list:
    st.model = st.estimator = None
    if st.device != "cpu":
        torch.cuda.empty_cache()
    ref = reference_run(st, nets.rounding("none"))
    return numbers(st.losses, st.batches[0], st.first_grad, st.after, ref, st.p_vsr)


def control(cfg, traffic, seed, device, precision: str) -> list:
    """The reference at a lower precision in the program's place, on the
    HR windows the set-up would take."""
    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device, seed=seed,
                         pool=make_pool(traffic, seed, device),
                         rng=np.random.default_rng(inputs.stream_seed(seed, "traffic")))
    st.p_vsr = inputs.make_params(inputs.vsr_spec(cfg), seed, "weights_vsr", device)
    st.p_est = inputs.make_params(inputs.est_spec(cfg), seed, "weights_est", device)
    m = cfg["meta"]
    st.hr = [crops(st.pool, st.rng, m["batch_size"], m["N_frames"], m["GT_size"])
             for _ in range(int(traffic["check_steps"]))]
    low = reference_run(st, nets.rounding(precision))
    ref = reference_run(st, nets.rounding("none"))
    return numbers(list(zip(low["outer"], low["inner"])), low["batch0"], low["first_grads"],
                   low["params"], ref, st.p_vsr)


def unit_flops(st) -> float:
    """The reference's FLOPs of one update: MFDN on the LR windows, the
    inner forward and backward, the outer forward and the backward through
    both (second order)."""
    from torch.utils.flop_counter import FlopCounterMode

    hr = torch.as_tensor(st.hr[0], device=st.device)
    q = nets.rounding("none")
    with FlopCounterMode(display=False) as fc:
        batch = ref_meta.synthesize(synth_generator(st.seed, 0, st.device), hr,
                                    st.cfg["scale"], st.p_est, q)
        ref_meta.meta_grads(st.p_vsr, batch, st.cfg["network_G"],
                            st.cfg["meta"]["maml_lr_alpha"], q)
    return fc.get_total_flops()
