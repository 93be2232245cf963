"""DUF-16L's second-order meta term (chip_smoke.term_vs_plain with its
float64 gauge) at four random inits and random batches of 2 windows, at
alpha 1e-2 and 1; during each kernel evaluation, every
DufBwdFunction.backward (K6 / K7 composed) is recorded and held against
the plain filter's double backward in float64 on its own inputs (largest
distance relative to the largest value). Prints one `[duf2]` line a case.

    python3 tools/duf_term_probe.py   (on a machine with the card)
"""
import os
import sys
import types

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from dynavsr_tpu_torch.models import duf as duf_module  # noqa: E402
from dynavsr_tpu_torch.models.networks import define_G  # noqa: E402
from dynavsr_tpu_torch.ops import duf_filter  # noqa: E402
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref  # noqa: E402

smi = cs.phase_device()
cs.phase_build()
dev = cs.resolve_device(None)
swap = (duf_module, "dynamic_upsampling_filter", dynamic_upsampling_filter_ref)
recorded = []
orig_bwd = duf_filter.DufBwdFunction.backward


def rec_bwd(ctx, cx, cf):
    out = orig_bwd(ctx, cx, cf)
    x, f, go = ctx.saved_tensors
    recorded.append(dict(x=x.detach().clone(), f=f.detach().clone(), go=go.detach().clone(),
                         cx=None if cx is None else cx.detach().clone(),
                         cf=None if cf is None else cf.detach().clone(),
                         need=ctx.needs_input_grad[:3],
                         out=[None if t is None else t.detach().clone() for t in out[:3]]))
    return out


def plain_double(r):
    """The plain filter's double backward in float64 on a recorded call's
    inputs and cotangents: (grad x, grad filters, grad grad_out)."""
    with torch.enable_grad():
        xr, fr, gor = (r[k].double().requires_grad_() for k in ("x", "f", "go"))
        out = dynamic_upsampling_filter_ref(xr, fr)
        gx, gf = torch.autograd.grad(out, [xr, fr], gor, create_graph=True)
        outs, cots = [], []
        if r["cx"] is not None:
            outs.append(gx), cots.append(r["cx"].double())
        if r["cf"] is not None:
            outs.append(gf), cots.append(r["cf"].double())
        got = torch.autograd.grad(outs, [xr, fr, gor], cots, allow_unused=True)
    return got


for seed in range(4):
    torch.manual_seed(seed)
    net = define_G({"scale": 4, "network_G": {"which_model_G": "DUF_16L", "nframes": 7}}, dev)
    model = types.SimpleNamespace(netG=net.eval())
    g = torch.Generator(device="cuda").manual_seed(seed)
    lr = torch.rand(2, 7, 64, 64, 3, generator=g, device="cuda")
    batch = {"SLR": torch.rand(2, 7, 16, 16, 3, generator=g, device="cuda"), "LR": lr,
             "LR_center": lr[:, 3].clone(), "HR_center": torch.rand(2, 256, 256, 3, generator=g,
                                                                   device="cuda")}
    for alpha in (1e-2, 1.0):
        recorded.clear()
        duf_filter.DufBwdFunction.backward = staticmethod(rec_bwd)
        try:
            r = cs.term_vs_plain(model, batch, alpha, swap, gauge=True)
        finally:
            duf_filter.DufBwdFunction.backward = staticmethod(orig_bwd)
        worst = []
        for rr in recorded:
            want = plain_double(rr)
            for got, w, name in zip(rr["out"], want, ("gx", "gf", "ggo")):
                if got is None or w is None:
                    continue
                worst.append((name, float((got.double() - w).abs().max() / w.abs().max())))
        print(f"[duf2] seed {seed} alpha {alpha}: term share {r['share']:.3e}, kernels vs plain "
              f"{r['rel_diff']:.3e}, plain vs f64 {r['plain_vs_f64']:.3e}, kernels vs f64 "
              f"{r['kernel_vs_f64']:.3e}, first {r['first_rel_diff']:.3e}; "
              f"{len(recorded)} double backwards, worst vs float64 "
              f"{sorted(worst, key=lambda t: -t[1])[:3]}", flush=True)
print(smi)
