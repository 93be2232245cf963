"""Driver of DynaVSR's per-clip serving: clips run back to back (closed
loop) through the port's per-clip entry, cli/test_dynavsr.run_clip, which
estimates the SLR windows with MFDN, adapts a copy of the VSR net with k
Adam steps and super-resolves every window of the clip, delivering the SR
frames to host memory.

Traffic: a pool of clips made from the seed in host memory (moving
sinusoids at the LR size), cycled. The unit is one clip.

Correctness: one clip of the window, drawn from the seed (among the first
`check_among`), is held against the plain reference, which works the SLR
windows, the adapted weights and the SR frames out again from the same
weights and frames: MFDN's SLR windows, the adaptation's per-step losses,
the change of every weight leaf, and `check_frames` SR frames drawn from
the seed (the first and last frame always).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.reference import adapt as ref_adapt
from benchmark.reference import nets


def _port():
    from dynavsr_tpu_torch.adapt import adaptation
    from dynavsr_tpu_torch.cli import test_dynavsr
    from dynavsr_tpu_torch.models.networks import define_G
    from dynavsr_tpu_torch.ops import dcn
    return SimpleNamespace(adaptation=adaptation, test_dynavsr=test_dynavsr,
                           define_G=define_G, dcn=dcn)


def build_nets(cfg: dict, seed: int, device):
    """The port's VSR net and MFDN with the seed's weights, and the same
    tensors for the reference."""
    port = _port()
    g, e = cfg["network_G"], cfg["network_E"]
    vsr = port.define_G({"scale": cfg["scale"], "network_G": {"which_model_G": "EDVR", **g}},
                        device)
    est = port.test_dynavsr.build_estimator({"which_model_G": "MFDN", **e}, cfg["scale"],
                                            g["nframes"], device)
    p_vsr = inputs.make_params(inputs.vsr_spec(cfg), seed, "weights_vsr", device)
    p_est = inputs.make_params(inputs.est_spec(cfg), seed, "weights_est", device)
    vsr.load_state_dict(p_vsr, strict=True)
    est.load_state_dict(p_est, strict=True)
    return port, vsr, est, p_vsr, p_est


def make_pool(traffic: dict, seed: int, device) -> list:
    gen = inputs.generator(seed, "traffic", device)
    c = traffic["clip"]
    return [inputs.sinusoids(gen, c["frames"], c["lr_h"], c["lr_w"], c["components"],
                             c["freq"], c["speed"]).cpu().numpy()
            for _ in range(traffic["pool"])]


def check_choice(traffic: dict, seed: int):
    """The clip the check takes (among the first `check_among`) and its SR
    frames (`check_frames` of them, the first and last always), drawn from
    the seed."""
    rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
    clip = int(rng.integers(traffic["check_among"]))
    t = traffic["clip"]["frames"]
    inner = rng.choice(np.arange(1, t - 1), traffic["check_frames"] - 2, replace=False)
    return clip, sorted({0, t - 1, *map(int, inner)})


def setup(cfg, traffic, seed, device, tracer):
    port, vsr, est, p_vsr, p_est = build_nets(cfg, seed, device)
    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device, port=port, vsr=vsr, est=est,
                         p_vsr=p_vsr, p_est=p_est, units=0,
                         acfg=port.test_dynavsr.adapt_config(cfg["adapt"]))
    st.pool = make_pool(traffic, seed, device)
    st.check_clip, st.check_frames = check_choice(traffic, seed)
    st.kept = None  # (clip, sampled SR frames, losses, adapted weights, SLR windows)
    st.armed = False
    st.adapted = st.slr = None

    ad = port.adaptation
    tracer.wrap_factory(ad, "make_adapt_fn", "adapt")
    tracer.wrap(ad, "chunked_apply", "infer")
    tracer.record_dcn(port.dcn)
    make = ad.make_adapt_fn

    def capturing(*a, **k):  # keeps the SLR windows and adapted module of an armed clip
        fn = make(*a, **k)

        def adapt(meta_model, slr_windows, *b, **kw):
            model, losses = fn(meta_model, slr_windows, *b, **kw)
            if st.armed:
                st.adapted, st.slr = model, slr_windows.detach().clone()
            return model, losses
        return adapt

    tracer.patch(ad, "make_adapt_fn", capturing)
    one_clip(st, 0, keep=False)  # warm-up: every shape of a clip
    return st


def one_clip(st, i: int, keep: bool = True) -> int:
    """Serve clip i of the loop; returns the frames delivered."""
    lq = st.pool[i % len(st.pool)]
    st.armed = keep and i <= st.check_clip
    sr, res = st.port.test_dynavsr.run_clip(
        st.vsr, st.est, lq, None, st.acfg, seq=False, n_frames=st.cfg["network_G"]["nframes"],
        padding="reflection", n_adapt=int(st.cfg["adapt"]["n_windows"]),
        scale=st.cfg["scale"], device=st.device)
    if st.armed:
        st.kept = (i, {f: sr[f].copy() for f in st.check_frames}, list(res["adapt_losses"]),
                   {k: v.detach().clone() for k, v in st.adapted.state_dict().items()}, st.slr)
        st.adapted = st.slr = None
    return sr.shape[0]


def window(st, seconds: float) -> dict:
    t0 = time.perf_counter()
    frames, i = 0, 0
    while True:
        frames += one_clip(st, i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    st.units = i
    return {"frames_per_s": frames / (time.perf_counter() - t0)}


def traced(st, tracer) -> None:
    n = int(st.traffic["traced_units"])
    for i in range(n):
        tracer.count("frames", one_clip(st, i))
        tracer.count("units")
    st.units = n
    tracer.trace.info["dtype"] = "bf16" if st.cfg["network_G"].get("dtype") == "bf16" else "fp32"


def reference_answer(st, clip: int, q) -> dict:
    lq = torch.as_tensor(st.pool[clip % len(st.pool)], device=st.device)
    win = ref_adapt.windows(lq.shape[0], st.cfg["network_G"]["nframes"]).to(st.device)
    return ref_adapt.serve_clip(st.p_vsr, st.p_est, lq, win, st.check_frames, st.cfg, q)


def numbers(prog_slr, prog_sr, prog_losses, prog_adapted, ref, p0) -> list:
    ch = compare.change_numbers(prog_adapted, ref["adapted"], p0, ref["first_grads"])
    return [("slr_max_abs", compare.max_abs({0: prog_slr}, {0: ref["slr"]})),
            ("sr_max_abs", compare.max_abs(prog_sr, ref["sr"])),
            ("loss_rel", compare.rel_gap(prog_losses, ref["losses"])),
            ("weight_change_gap", ch["weight_change_gap"]),
            ("weight_change_median", ch["weight_change_median"]),
            ("_worst_leaves", ch["_worst"])]


def check(st, seed) -> list:
    clip, sr, losses, adapted, slr = st.kept
    st.vsr = st.est = None  # the program's state goes before the reference runs
    if st.device != "cpu":
        torch.cuda.empty_cache()
    ref = reference_answer(st, clip, nets.rounding("none"))
    return numbers(slr, sr, losses, adapted, ref, st.p_vsr)


def control(cfg, traffic, seed, device, precision: str) -> list:
    """The control: the reference at a lower precision in the program's
    place, on the clip and frames the check would take, held against the
    reference by the same numbers."""
    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device)
    st.p_vsr = inputs.make_params(inputs.vsr_spec(cfg), seed, "weights_vsr", device)
    st.p_est = inputs.make_params(inputs.est_spec(cfg), seed, "weights_est", device)
    st.pool = make_pool(traffic, seed, device)
    clip, st.check_frames = check_choice(traffic, seed)
    low = reference_answer(st, clip, nets.rounding(precision))
    ref = reference_answer(st, clip, nets.rounding("none"))
    return numbers(low["slr"], {f: v.cpu().numpy() for f, v in low["sr"].items()},
                   low["losses"], low["adapted"], ref, st.p_vsr)


def unit_flops(st) -> float:
    """The reference's FLOPs of one clip: MFDN over the adaptation windows,
    k steps of forward and backward on them, one forward a frame."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg, q = st.cfg, nets.rounding("none")
    arch, t = cfg["network_G"], st.traffic["clip"]["frames"]
    lq = torch.as_tensor(st.pool[0], device=st.device)
    win = ref_adapt.windows(t, arch["nframes"]).to(st.device)
    k = min(int(cfg["adapt"]["n_windows"]), t)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            slr = nets.mfdn(st.p_est, lq[win[:k]], cfg["scale"], q)
    est = fc.get_total_flops()
    leaves = {n: v.detach().requires_grad_() for n, v in st.p_vsr.items()}
    with FlopCounterMode(display=False) as fc:
        loss = nets.edvr_padded(leaves, slr, arch, q).sum()
        torch.autograd.grad(loss, list(leaves.values()))
    step = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            nets.edvr_padded(st.p_vsr, lq[win[:1]], arch, q)
    return est + int(cfg["adapt"]["n_steps"]) * step + t * fc.get_total_flops()
