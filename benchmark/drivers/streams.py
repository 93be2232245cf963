"""Driver of live feeds: eval/streaming.MultiStreamSR with B streams in
G groups (each group its own adapted copy of the net), fed one frame of
every stream per push, offered at a fixed rate (open loop: `rate_hz`
pushes a second, whatever the program's pace); a push is done when its SR
frames are in host memory.

Set-up: each group adapts on the first K windows of its streams
(make_streaming_adapter(batched=True): MFDN's SLR windows, k Adam steps),
inside the push that completes those windows, then a few steady pushes.
Traffic: every stream's frames cycle through its own pool of frames made
from the seed in host memory. The unit is one push.

Correctness: each group's adaptation (MFDN's SLR windows, per-step
losses, each leaf's change) and every stream's SR frames of `check_pushes`
pushes of the window, drawn from the seed, against the plain reference,
which adapts each stream's net on the same windows and super-resolves the
same windows. The reference adapts one net a stream, so the traffic has
as many groups as streams.
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
    from dynavsr_tpu_torch.adapt.adaptation import AdaptConfig
    from dynavsr_tpu_torch.eval import streaming
    from dynavsr_tpu_torch.models.padding import make_model_apply
    from dynavsr_tpu_torch.ops import dcn
    return SimpleNamespace(AdaptConfig=AdaptConfig, streaming=streaming,
                           make_model_apply=make_model_apply, dcn=dcn)


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """(streams, frames, h, w, 3): each stream's own frames."""
    gen = inputs.generator(seed, "traffic", device)
    c = traffic["clip"]
    return np.stack([inputs.sinusoids(gen, traffic["pool_frames"], traffic["h"], traffic["w"],
                                      c["components"], c["freq"], c["speed"]).cpu().numpy()
                     for _ in range(traffic["streams"])])


def stream_frames(pool: np.ndarray, t: int) -> np.ndarray:
    """Frame t of every stream, (B, h, w, 3)."""
    return np.ascontiguousarray(pool[:, t % pool.shape[1]])


def check_choice(cfg: dict, traffic: dict, seed: int):
    """The pushes of the window the check keeps (among its first
    `check_among`), drawn from the seed, and the centre frames their SR
    frames stand for: the ring emits its first window's centre with the
    push that completes the K adaptation windows, then one centre a push,
    and the window starts after `warm_pushes` more."""
    rng = np.random.default_rng(inputs.stream_seed(seed, "check"))
    pushes = {int(i) for i in rng.choice(traffic["check_among"], traffic["check_pushes"],
                                         replace=False)}
    first = int(cfg["adapt"]["n_windows"]) + int(traffic["warm_pushes"])
    return pushes, {first + i for i in pushes}


def setup(cfg, traffic, seed, device, tracer):
    from benchmark.drivers import clips  # the same nets and weights as the clip cells

    port = _port()
    if traffic["groups"] != traffic["streams"]:
        raise ValueError("the reference adapts one net a stream: groups must equal streams")
    _, vsr, est, p_vsr, p_est = clips.build_nets(cfg, seed, device)
    ad = cfg["adapt"]
    acfg = port.AdaptConfig(n_steps=int(ad["n_steps"]), lr=float(ad["lr"]),
                            optimizer=ad["optimizer"])
    slr = []  # each group's SLR windows, in the order the groups adapt
    make = port.streaming.make_adapt_fn

    def capturing(*a, **k):
        fn = make(*a, **k)

        def adapt(meta_model, slr_windows, *b, **kw):
            slr.append(slr_windows.detach().clone())
            return fn(meta_model, slr_windows, *b, **kw)
        return adapt

    tracer.patch(port.streaming, "make_adapt_fn", capturing)
    adapter = port.streaming.make_streaming_adapter(
        acfg, est, apply_fn=port.make_model_apply("EDVR", cfg["scale"]), batched=True)
    ms = port.streaming.MultiStreamSR(vsr, traffic["streams"], cfg["network_G"]["nframes"],
                                      cfg["padding"], adapter=adapter,
                                      adapt_windows=int(ad["n_windows"]),
                                      n_groups=traffic["groups"])
    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device, ms=ms, p_vsr=p_vsr,
                         p_est=p_est, pool=make_pool(traffic, seed, device), t=0, units=0,
                         kept={}, slr=slr)
    st.check_at, st.kept_centres = check_choice(cfg, traffic, seed)
    tracer.record_dcn(port.dcn)
    while ms.adapt_losses is None:  # buffered pushes, then the adaptation
        push(st)
    for _ in range(int(traffic["warm_pushes"])):
        push(st)
    st.losses = ms.adapt_losses.detach().cpu().tolist()
    st.adapted = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in ms.models]
    return st


def push(st, keep: bool = False):
    """One push of every stream's next frame; the SR frames it emits are
    copied to host memory. Returns (emissions, host seconds until push
    returned)."""
    t0 = time.perf_counter()
    outs = st.ms.push(stream_frames(st.pool, st.t))
    host = time.perf_counter() - t0
    st.t += 1
    outs = [(c, sr.cpu().numpy()) for c, sr in outs]
    if keep:
        for c, sr in outs:
            st.kept[c] = sr
    return outs, host


def paced(st, n_min: int, seconds: float, step) -> list:
    """Pushes offered at the traffic's fixed rate (`rate_hz` pushes a
    second, open loop) until `seconds` have passed and at least `n_min`
    were made; step(i, due) makes push i. Returns each push's latency from
    when it was due to when its SR frames were in host memory, which counts
    the wait a late push imposes on the next."""
    period = 1.0 / float(st.traffic["rate_hz"])
    t0 = time.perf_counter()
    lat, i = [], 0
    while True:
        due = t0 + i * period
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        step(i, due)
        lat.append(time.perf_counter() - due)
        i += 1
        if time.perf_counter() - t0 >= seconds and i >= n_min:
            return lat


def window(st, seconds: float) -> dict:
    lat = paced(st, max(st.check_at) + 1, seconds,
                lambda i, due: push(st, keep=i in st.check_at))
    st.units = len(lat)
    lat.sort()
    return {"push_ms_p95": 1e3 * lat[int(np.ceil(0.95 * len(lat))) - 1]}


def traced(st, tracer) -> None:
    def step(i, due):
        with tracer.span("push"):
            _, host = push(st, keep=i in st.check_at)
        tracer.trace.spans.setdefault("push_host", []).append((0.0, host))
        tracer.count("units")

    n = max(int(st.traffic["traced_units"]), max(st.check_at) + 1)
    st.units = len(paced(st, n, 0.0, step))
    tracer.trace.info["dtype"] = "bf16" if st.cfg["network_G"].get("dtype") == "bf16" else "fp32"


def _stream_windows(st, s: int, centres) -> torch.Tensor:
    """Stream s's windows (len(centres), N, h, w, 3) as the ring builds
    them: reflection at the stream's start, no end in sight."""
    n = st.cfg["network_G"]["nframes"]
    win = ref_adapt.windows(max(centres) + n, n)[list(centres)]
    return torch.as_tensor(st.pool[s][win.numpy() % st.pool.shape[1]], device=st.device)


def reference_answer(st, q) -> dict:
    """Per stream: the adaptation on its first K windows (SLR, losses,
    adapted tensors) and its SR frames at the kept centres."""
    cfg, b = st.cfg, st.traffic["streams"]
    k, arch = int(cfg["adapt"]["n_windows"]), cfg["network_G"]
    out = []
    for s in range(b):
        aw = _stream_windows(st, s, range(k))
        with torch.no_grad():
            slr = nets.mfdn(st.p_est, aw, cfg["scale"], q)
        adapted, losses, first = ref_adapt.adapt(st.p_vsr, slr, aw[:, aw.shape[1] // 2], arch,
                                                 int(cfg["adapt"]["n_steps"]),
                                                 float(cfg["adapt"]["lr"]), q)
        sr = {}
        with torch.no_grad():
            for c in sorted(st.kept_centres):
                sr[c] = nets.edvr_padded(adapted, _stream_windows(st, s, [c]), arch, q)[0]
        out.append({"slr": slr, "losses": losses, "adapted": adapted, "first_grads": first,
                    "sr": sr})
    return out


def numbers(prog_slr, prog_losses, prog_adapted, prog_sr, ref, p0) -> list:
    """Worst over the streams of: the SLR windows' and the SR frames'
    largest gaps, the losses' relative gap, the leaves' change numbers."""
    out = {"slr_max_abs": 0.0, "sr_max_abs": 0.0, "loss_rel": 0.0, "weight_change_gap": 0.0,
           "weight_change_median": 0.0, "_worst_leaves": []}
    if len(prog_slr) != len(ref):
        raise ValueError(f"{len(prog_slr)} adaptations for {len(ref)} streams")
    for s, r in enumerate(ref):
        ch = compare.change_numbers(prog_adapted[s], r["adapted"], p0, r["first_grads"])
        out["slr_max_abs"] = max(out["slr_max_abs"],
                                 compare.max_abs({0: prog_slr[s]}, {0: r["slr"]}))
        out["sr_max_abs"] = max(out["sr_max_abs"],
                                compare.max_abs({c: prog_sr[c][s] for c in r["sr"]}, r["sr"]))
        out["loss_rel"] = max(out["loss_rel"], compare.rel_gap(prog_losses[s], r["losses"]))
        for k in ("weight_change_gap", "weight_change_median"):
            out[k] = max(out[k], ch[k])
        out["_worst_leaves"] += ch["_worst"]
    return list(out.items())


def check(st, seed) -> list:
    st.ms = None
    if st.device != "cpu":
        torch.cuda.empty_cache()
    if set(st.kept) != st.kept_centres:
        raise RuntimeError(f"the kept pushes emitted centres {sorted(st.kept)}, "
                           f"not {sorted(st.kept_centres)}")
    ref = reference_answer(st, nets.rounding("none"))
    return numbers(st.slr, st.losses, st.adapted, st.kept, ref, st.p_vsr)


def control(cfg, traffic, seed, device, precision: str) -> list:
    """The reference at a lower precision in the program's place: every
    stream's adaptation and its SR frames at the centres the check would
    take."""
    st = SimpleNamespace(cfg=cfg, traffic=traffic, device=device,
                         pool=make_pool(traffic, seed, device))
    st.p_vsr = inputs.make_params(inputs.vsr_spec(cfg), seed, "weights_vsr", device)
    st.p_est = inputs.make_params(inputs.est_spec(cfg), seed, "weights_est", device)
    _, st.kept_centres = check_choice(cfg, traffic, seed)
    low = reference_answer(st, nets.rounding(precision))
    ref = reference_answer(st, nets.rounding("none"))
    return numbers([r["slr"] for r in low], [r["losses"] for r in low],
                   [r["adapted"] for r in low],
                   {c: torch.stack([r["sr"][c] for r in low]).cpu().numpy()
                    for c in st.kept_centres}, ref, st.p_vsr)


def unit_flops(st) -> float:
    """The reference's FLOPs of one push: every stream's new frame through
    the feature pyramid and one window through alignment, fusion and the
    trunk."""
    from torch.utils.flop_counter import FlopCounterMode

    q, arch, n = nets.rounding("none"), st.cfg["network_G"], st.cfg["network_G"]["nframes"]
    x = _stream_windows(st, 0, [n])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        nets.pyramid(st.p_vsr, x[0, :1], arch, q)
    per_frame = fc.get_total_flops()
    with torch.no_grad():
        levels = [v.reshape(1, n, *v.shape[1:]) for v in nets.pyramid(st.p_vsr, x[0], arch, q)]
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        nets.fuse(st.p_vsr, levels, x[:, n // 2], arch, q)
    return st.traffic["streams"] * (per_frame + fc.get_total_flops())
