"""The second order in bf16 on CPU: the DCN (K1-K3, K8-K10's function), the
dynamic filter (K6 / K7) and an EDVR-L-shaped meta gradient, against the
JAX package on the same numpy inputs from a seed.

JAX's bf16 autodiff rounds at other points than the port (its cotangents
are bf16 wherever its primal values are; the port keeps column gradients
and sums in fp32, as the kernels do), so a bf16 result of either side lies
a bf16-sized distance from the exact one. Each check is gauged by that
distance, computed inside the test:

- (a) The DCN's grad-of-grad in bf16, along cotangents that reach every
  input (the offsets' too, so that K8-K10's terms carry the signal): for
  each of x, offset, mask and weight, the port's plain op (its CPU path,
  `deform_conv2d` on bf16 tensors: bf16 columns and weights, fp32 sums)
  lies within 2 x JAX-bf16's distance from a float64 evaluation of the same
  function (the port's plain op in float64), plus a floor of 2^-8 of the
  largest float64 value (one bf16 step), all in max-abs. The terms through
  the offset cotangent are more than 10 x that bound.
- (b) The bf16 plain tangent formulas (ops/dcn_ref.py's *_tangent_ref with
  compute_dtype bf16, what the card holds bf16 K8-K10 to) against the
  double autograd of the bf16 plain op, whose rounding is straight-through
  and so takes the tangent columns unrounded: K10, the same fp32
  arithmetic, within 2^-7 of the largest value (the two fp32 results may
  round to neighbouring bf16 values: one bf16 step, at most 2^-7 of the
  value); K8 and K9, which also round those columns to bf16 for the tensor
  cores, within 2^-6 (measured up to 7.6e-3 over four seeds).
- (c) `DeformConv2dFunction` / `DufFilterFunction` in bf16, their launchers
  replaced by bf16 plain stand-ins that return values without a graph and
  count their calls: the grad-of-grad in every input goes through
  `DcnBwdDataFunction` / `DcnBwdWeightFunction` (K1-K3 and one call each of
  K8-K10) and `DufBwdFunction` (K6 / K7), and equals plain bf16 autograd
  within 2^-6 of the largest value (each kernel's result is rounded to bf16
  before the Function adds the terms, and K8 / K9 round their columns);
  one bf16 meta update of an EDVR and of DUF-16L launches what
  chip_smoke.py phase 15 checks (EDVR: K1 28, K2 24, K3 20, K8-K10 4; DUF:
  K6 5, K7 3), the fp32 counts.
- (d) The dynamic filter's grad-of-grad with bf16 filters (x fp32, as DUF's
  bf16 mode runs it) against JAX's `dynamic_upsampling_filter`, gauged as
  (a).
- (e) The whole slice: the second-order meta gradient of an EDVR-L-shaped
  net (nf 128, Gd 8, TSA, bf16; cut to 3 frames and 1 + 2 blocks from 5
  and 5 + 40, and to a batch of 2 windows of SLR 4x4, LR 16x16, HR 64x64)
  against JAX's (its init; one compile of the gradient). Each parameter
  tensor of the port's bf16 gradient lies within 2 x JAX-bf16's distance
  from the port's fp32 gradient (which test_torch_port_meta.py holds to
  JAX's fp32 within 1e-5) plus 1e-3 of that tensor's norm, in norm: JAX's
  bf16 rounds its bilinear weights and every cotangent, so its gradient
  sits ~7e-2 of the gradient's norm from fp32, the port's ~3e-2 (measured),
  and by the triangle inequality the two bf16 gradients are at most ~1.5 x
  JAX's distance apart (the worst tensor measured at 0.74 of its
  tolerance). The inner lr (1000) makes the second-order part (fp32,
  second minus first order) ~all of the gradient, more than 10 x its
  tensor's tolerance where it is largest (measured 25.6 x), so a dropped
  term shows. MetaModel builds and steps a bf16 EDVR and a bf16 DUF at
  second order; a third backward through the bf16 Functions raises.

The module runs torch on one intra-op thread (restored after).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.convert.torch_import import convert_state_dict
from dynavsr_tpu.models.duf import dynamic_upsampling_filter as jax_duf_filter
from dynavsr_tpu.models.edvr import EDVR as JaxEDVR
from dynavsr_tpu.models.padding import make_model_apply as jax_model_apply
from dynavsr_tpu.ops.dcn_fused import deform_conv2d_fused as jax_dcn
from dynavsr_tpu.train import meta as jax_meta
from dynavsr_tpu.train.losses import charbonnier_loss as jax_charbonnier
from dynavsr_tpu_torch.convert.from_jax import jax_params_to_state_dict
from dynavsr_tpu_torch.models import duf as duf_module
from dynavsr_tpu_torch.models import edvr as edvr_module
from dynavsr_tpu_torch.models.duf import DUF
from dynavsr_tpu_torch.models.edvr import EDVR
from dynavsr_tpu_torch.models.padding import make_model_apply
from dynavsr_tpu_torch.models.video_base_model import MetaModel, create_model
from dynavsr_tpu_torch.ops import dcn, duf_filter
from dynavsr_tpu_torch.ops.dcn_ref import (
    dcn_bwd_data_tangent_ref,
    dcn_bwd_weight_tangent_ref,
    dcn_fwd_tangent_ref,
    deform_conv2d_ref,
)
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref
from dynavsr_tpu_torch.train.checkpoint import save_network
from dynavsr_tpu_torch.train.meta import MetaConfig, make_meta_train_step, meta_loss
from dynavsr_tpu_torch.train.trainer import TrainerConfig, make_optimizer, make_schedule
from test_torch_port_meta_tof import count_launches, meta_batches
from torch_one_thread import one_thread  # noqa: F401

BF16 = torch.bfloat16
B, C, H, W, GD = 2, 8, 6, 6, 2
# The launches of one second-order meta update (remat on) in bf16, as in
# fp32: chip_smoke.py phase 15c / 15d's.
EDVR_LAUNCHES = {"_fwd": 28, "dcn_bwd_data": 24, "dcn_bwd_weight": 20, "dcn_fwd_tangent": 4,
                 "dcn_bwd_weight_tangent": 4, "dcn_bwd_data_tangent": 4}
DUF_LAUNCHES = {"duf_fwd": 5, "duf_bwd": 3}


def _bf16(a):
    """numpy fp32 -> the bf16-rounded values, as fp32 numpy (both sides read these)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(BF16).float().numpy()


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(dtype)


def _gauged(got, jax_got, exact, what, factor=2.0, floor=2.0 ** -8):
    """max|got - jax_got| <= factor x max|jax_got - exact| + floor x max|exact|."""
    got, jax_got, exact = (np.asarray(t, dtype=np.float64) for t in (got, jax_got, exact))
    scale = np.abs(exact).max()
    tol = factor * np.abs(jax_got - exact).max() + floor * scale
    err = np.abs(got - jax_got).max()
    assert err <= tol, (what, err, tol, scale)
    return tol


# ---------------------------------------------------------------- (a), (b)
def _dcn_case(seed=3):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((B, H, W, C)).astype(np.float32))
    off = _bf16((rng.standard_normal((B, H, W, 2 * GD * 9)) * 1.5 + 0.37).astype(np.float32))
    mask = _bf16(rng.random((B, H, W, GD * 9)).astype(np.float32))
    w = _bf16((rng.standard_normal((3, 3, C, C)) / np.sqrt(9 * C)).astype(np.float32))  # HWIO
    rs = [rng.standard_normal(a.shape).astype(np.float32) for a in (x, off, mask, w)]
    return (x, off, mask, w), rs


def _port_dcn_inputs(arrays, dtype):
    x, off, mask, w = arrays
    return [_nchw(x, dtype), _nchw(off, dtype), _nchw(mask, dtype),
            torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(dtype)]


def _to_nhwc(gs):
    """The port's grads (NCHW, OIHW) in JAX's layouts (NHWC, HWIO), float64."""
    x, off, mask, w = (g.double().numpy() for g in gs)
    return [np.moveaxis(x, 1, -1), np.moveaxis(off, 1, -1), np.moveaxis(mask, 1, -1),
            w.transpose(2, 3, 1, 0)]


def _loss(out):
    out = out.float() if torch.is_tensor(out) else out.astype(jnp.float32)
    return (out ** 2).sum() + (out ** 3).mean()


def _port_grad_of_grad(fn, inputs, rs):
    """d/d(inputs) of sum_i <r_i, dL/d input_i>, L = _loss(fn(*inputs))."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    gs = torch.autograd.grad(_loss(fn(*leaves)), leaves, create_graph=True)
    inner = sum((g.to(r.dtype) * r).sum() for g, r in zip(gs, rs))
    return torch.autograd.grad(inner, leaves)


@pytest.fixture(scope="module")
def dcn_case():
    arrays, rs = _dcn_case()

    def inner(x, o, m, w, r_off):
        def loss(x, o, m, w):
            return _loss(jax_dcn(x, o, m, w, deformable_groups=GD))
        gs = jax.grad(loss, argnums=(0, 1, 2, 3))(x, o, m, w)
        rr = (rs[0], r_off, rs[2], rs[3])
        return sum((g.astype(jnp.float32) * r).sum() for g, r in zip(gs, rr))

    jin = [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]
    jax_gg = jax.jit(jax.grad(inner, argnums=(0, 1, 2, 3)))(*jin, jnp.asarray(rs[1]))
    return arrays, rs, [np.asarray(g, dtype=np.float64) for g in jax_gg]


def test_dcn_bf16_grad_of_grad_matches_jax(dcn_case):
    """(a): every input's grad-of-grad in bf16, gauged by JAX-bf16's distance
    from float64; the offset cotangent's terms (K8-K10's) are > 10 x the
    bound of each input they reach."""
    arrays, rs, want = dcn_case

    def port(dtype, r_off=True):
        rr = [_port_dcn_inputs([r if i != 1 or r_off else 0 * r for i, r in enumerate(rs)],
                               torch.float64)[i] for i in range(4)]
        fn = (lambda x, o, m, w: deform_conv2d_ref(x, o, m, w, deformable_groups=GD)) \
            if dtype == torch.float64 else \
            (lambda x, o, m, w: dcn.deform_conv2d(x, o, m, w, deformable_groups=GD))
        return _to_nhwc(_port_grad_of_grad(fn, _port_dcn_inputs(arrays, dtype), rr))

    got, exact, no_off = port(BF16), port(torch.float64), port(BF16, r_off=False)
    for i, name in enumerate(("x", "offset", "mask", "weight")):
        tol = _gauged(got[i], want[i], exact[i], name)
        assert np.abs(got[i] - no_off[i]).max() > 10 * tol, name


def _tangents_by_autograd(x, o, m, w, go, coff):
    """K8 (d/d grad_out), K9 (d/d weight) and K10 (d/d (x, offset, mask)) of
    <d<out, grad_out>/d offset, coff>, out the bf16 plain op."""
    leaves = [t.clone().requires_grad_() for t in (x, o, m, w, go)]
    out = deform_conv2d_ref(*leaves[:4], deformable_groups=GD, compute_dtype=BF16)
    (goff,) = torch.autograd.grad((out.float() * leaves[4].float()).sum(), leaves[1],
                                  create_graph=True)
    gx, go_off, gm, gw, ggo = torch.autograd.grad((goff.float() * coff.float()).sum(), leaves)
    return ggo, gw, (gx, go_off, gm)


def test_bf16_tangent_formulas_match_double_autograd():
    """(b): the bf16 K8-K10 formulas against the double autograd of the
    bf16 plain op."""
    arrays, _ = _dcn_case(seed=4)
    x, o, m, w = _port_dcn_inputs(arrays, BF16)
    g = torch.Generator().manual_seed(4)
    go = torch.randn(B, C, H, W, generator=g).to(BF16)
    coff = torch.randn(o.shape, generator=g).to(BF16)
    k8, k9, k10 = _tangents_by_autograd(x, o, m, w, go, coff)
    f32 = [t.float() for t in (x, o, m, w, go, coff)]
    fx, fo, fm, fw, fgo, fcoff = f32
    pairs = [(dcn_fwd_tangent_ref(fx, fo, fm, fw, fcoff, GD, compute_dtype=BF16), k8, 2.0 ** -6),
             (dcn_bwd_weight_tangent_ref(fx, fo, fm, fgo, fcoff, GD, compute_dtype=BF16), k9,
              2.0 ** -6)]
    pairs += [(a, b, 2.0 ** -7) for a, b in zip(
        dcn_bwd_data_tangent_ref(fx, fo, fm, fw, fgo, fcoff, GD, compute_dtype=BF16), k10)]
    for got, want, tol in pairs:
        got = got.to(BF16).float()
        torch.testing.assert_close(got, want.float(), rtol=0,
                                   atol=tol * float(want.float().abs().max()))


# ---------------------------------------------------------------------- (c)
def _detached(fn):
    def call(*args, **kwargs):
        with torch.no_grad():
            out = fn(*args, **kwargs)
        return out.detach() if torch.is_tensor(out) else tuple(
            None if t is None else t.detach() for t in out)
    return call


def _vjp(fn, inputs, need, grad_out):
    need = [n and t is not None for t, n in zip(inputs, need)]
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, need)]
        out = fn(*leaves)
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, grad_out.detach()))
    return [next(grads) if n else None for n in need]


def _bf16_stand_ins(monkeypatch):
    """The DCN's and the filter's launchers replaced by their plain versions
    at the kernels' bf16 rounding points (compute_dtype = x's dtype), which
    return values without a graph, as the kernels do. Returns a function that
    their calls."""
    def plain(gd, cd):
        return lambda x, o, m, w: deform_conv2d_ref(x, o, m, w, deformable_groups=gd,
                                                    compute_dtype=cd)

    def fwd(x, offset, mask, weight, bias, gd):
        return (deform_conv2d_ref(x, offset, mask, weight, bias, deformable_groups=gd,
                                  compute_dtype=x.dtype),
                x.contiguous(memory_format=torch.channels_last))

    def bwd_data(x, offset, mask, weight, grad_out, gd):
        return tuple(_vjp(plain(gd, x.dtype), (x, offset, mask, weight),
                          (True, True, True, False), grad_out)[:3])

    def bwd_weight(x, offset, mask, grad_out, gd):
        w = x.new_zeros(grad_out.shape[1], x.shape[1], 3, 3)  # grad weight is linear
        return _vjp(plain(gd, x.dtype), (x, offset, mask, w), (False, False, False, True),
                    grad_out)[3]

    def tangent(ref):
        return _detached(lambda *a: ref(*a, compute_dtype=a[0].dtype))

    monkeypatch.setattr(dcn, "_fwd", _detached(fwd))
    monkeypatch.setattr(dcn, "dcn_bwd_data", bwd_data)
    monkeypatch.setattr(dcn, "dcn_bwd_weight", bwd_weight)
    monkeypatch.setattr(dcn, "dcn_fwd_tangent", tangent(dcn_fwd_tangent_ref))
    monkeypatch.setattr(dcn, "dcn_bwd_weight_tangent", tangent(dcn_bwd_weight_tangent_ref))
    monkeypatch.setattr(dcn, "dcn_bwd_data_tangent", tangent(dcn_bwd_data_tangent_ref))
    monkeypatch.setattr(duf_filter, "duf_fwd", _detached(dynamic_upsampling_filter_ref))
    monkeypatch.setattr(duf_filter, "duf_bwd", lambda x, f, grad_out, need_x: tuple(_vjp(
        dynamic_upsampling_filter_ref, (x, f), (need_x, True), grad_out)))
    dcn_calls = count_launches(dcn, EDVR_LAUNCHES, monkeypatch)
    duf_calls = count_launches(duf_filter, DUF_LAUNCHES, monkeypatch)
    return lambda: {**dcn_calls, **duf_calls}


@pytest.mark.parametrize("op", ["dcn", "duf"])
def test_bf16_second_order_through_the_kernel_functions(op, monkeypatch):
    """(c): grad-of-grad in every input through the kernels' Functions with
    bf16 stand-ins equals plain bf16 autograd, and routes through the
    second-order kernels."""
    calls = _bf16_stand_ins(monkeypatch)
    rng = np.random.default_rng(6)
    if op == "dcn":
        arrays, rs = _dcn_case(seed=6)
        inputs = _port_dcn_inputs(arrays, BF16)
        rs = _port_dcn_inputs(rs, torch.float32)
        function = lambda x, o, m, w: dcn.DeformConv2dFunction.apply(x, o, m, w, None, GD)  # noqa: E731
        plain = lambda x, o, m, w: deform_conv2d_ref(x, o, m, w, deformable_groups=GD,  # noqa: E731
                                                     compute_dtype=BF16)
    else:
        inputs = [torch.tensor(rng.random((B, 3, H, W)), dtype=torch.float32),
                  torch.tensor(rng.standard_normal((B, 25, 4, H, W)), dtype=BF16)]
        rs = [torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32) for t in inputs]
        function = duf_filter.DufFilterFunction.apply
        plain = dynamic_upsampling_filter_ref
    got = _port_grad_of_grad(function, inputs, rs)
    routed = calls()
    want = _port_grad_of_grad(plain, inputs, rs)
    for g, w_, t in zip(got, want, inputs):
        assert g.dtype == t.dtype
        torch.testing.assert_close(g.float(), w_.float(), rtol=0,
                                   atol=2.0 ** -6 * float(w_.float().abs().max()))
    if op == "dcn":
        assert all(routed[k] == 1 for k in ("dcn_fwd_tangent", "dcn_bwd_weight_tangent",
                                            "dcn_bwd_data_tangent")), routed
        assert all(routed[k] > 0 for k in ("_fwd", "dcn_bwd_data", "dcn_bwd_weight")), routed
    else:
        assert routed["duf_fwd"] > 1 and routed["duf_bwd"] > 1, routed


TINY_EDVR = dict(nf=16, nframes=3, groups=8, front_RBs=1, back_RBs=1)


@pytest.mark.parametrize("arch", ["EDVR", "DUF_16L"])
def test_bf16_meta_update_launches_with_the_kernel_stand_ins(arch, monkeypatch):
    """(c): one bf16 second-order meta update with remat makes the launches
    of an fp32 one (the counts chip_smoke.py phase 15 holds on the card)."""
    calls = _bf16_stand_ins(monkeypatch)
    monkeypatch.setattr(edvr_module, "deform_conv2d",
                        lambda x, o, m, w, b=None, deformable_groups=1:
                        dcn.DeformConv2dFunction.apply(x, o, m, w, b, deformable_groups))
    monkeypatch.setattr(duf_module, "dynamic_upsampling_filter",
                        duf_filter.DufFilterFunction.apply)
    torch.manual_seed(0)
    if arch == "EDVR":
        net = EDVR(**TINY_EDVR, dtype=BF16)
        with torch.no_grad():
            for name, p in net.named_parameters():
                if "conv_offset_mask.weight" in name:
                    p.normal_(0.0, 0.05)
        batch, want = meta_batches(3, 1, seed=2)[0], EDVR_LAUNCHES
    else:
        net, batch, want = DUF(dense1_layers=3, dtype=BF16).eval(), meta_batches(7, 1, 2)[0], \
            DUF_LAUNCHES
    cfg = TrainerConfig(lr=1e-4, scheme="constant")
    step = make_meta_train_step(net, MetaConfig(inner_lr=1.0), make_optimizer(
        cfg, net.parameters()), make_schedule(cfg), apply_fn=make_model_apply(net.arch, 4))
    before = calls()
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    after = calls()
    assert {k: after.get(k, 0) - before.get(k, 0) for k in want} == want
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---------------------------------------------------------------------- (d)
def test_duf_filter_bf16_grad_of_grad_matches_jax():
    """(d): x fp32, filters bf16; grad-of-grad in both, gauged as (a)."""
    rng = np.random.default_rng(8)
    x = rng.random((B, H, W, 3)).astype(np.float32)
    f = _bf16(rng.standard_normal((B, H, W, 25, 4)).astype(np.float32))
    rx, rf = (rng.standard_normal(a.shape).astype(np.float32) for a in (x, f))

    def inner(x, f):
        gs = jax.grad(lambda x, f: _loss(jax_duf_filter(x, f)), argnums=(0, 1))(x, f)
        return sum((g.astype(jnp.float32) * r).sum() for g, r in zip(gs, (rx, rf)))

    want = jax.jit(jax.grad(inner, argnums=(0, 1)))(jnp.asarray(x),
                                                      jnp.asarray(f, dtype=jnp.bfloat16))

    def port(xdt, fdt):
        inputs = [_nchw(x, xdt), torch.from_numpy(f.transpose(0, 3, 4, 1, 2).copy()).to(fdt)]
        rr = [_nchw(rx, xdt), torch.from_numpy(rf.transpose(0, 3, 4, 1, 2).copy()).to(xdt)]
        gx, gf = _port_grad_of_grad(duf_filter.dynamic_upsampling_filter, inputs, rr)
        return [np.moveaxis(gx.double().numpy(), 1, -1),
                gf.double().numpy().transpose(0, 3, 4, 1, 2)]

    got, exact = port(torch.float32, BF16), port(torch.float64, torch.float64)
    for i, name in enumerate(("x", "filters")):
        _gauged(got[i], np.asarray(want[i], dtype=np.float64), exact[i], name)


# ---------------------------------------------------------------------- (e)
# EDVR-L's widths (nf 128, Gd 8, TSA) cut to 3 frames and 1 + 2 blocks.
EDVR_L_CUT = dict(nf=128, nframes=3, groups=8, front_RBs=1, back_RBs=2)
ALPHA = 1000.0


@pytest.fixture(scope="module")
def edvr_l():
    """JAX's init of the EDVR-L-shaped net (offset convs redrawn N(0, 0.05),
    as test_torch_port_meta.py does, so the DCNs sample off the grid) in the
    port's names, a batch, and JAX's bf16 second-order meta gradient."""
    v = jax.tree.map(np.asarray, jax.jit(JaxEDVR(**EDVR_L_CUT).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3))))
    rng = np.random.default_rng(0)

    def redraw(tree):
        for k, leaf in tree.items():
            if k == "conv_offset_mask":
                leaf["kernel"] = (rng.standard_normal(leaf["kernel"].shape) * 0.05
                                  ).astype(np.float32)
            elif isinstance(leaf, dict):
                redraw(leaf)

    redraw(v["params"])
    sd = jax_params_to_state_dict(v, EDVR(**EDVR_L_CUT).state_dict())
    jm = JaxEDVR(**EDVR_L_CUT, dtype=jnp.bfloat16)
    batch = meta_batches(3, 1, seed=0)[0]
    apply = jax_model_apply(jm, "EDVR", 4)
    cfg = jax_meta.MetaConfig(inner_lr=ALPHA, first_order=False)

    def loss(p):
        fast, _ = jax_meta.adapted_params(jm, p, batch["SLR"], batch["LR_center"], cfg,
                                          apply_fn=apply)
        return jax_charbonnier(apply(fast, batch["LR"]), batch["HR_center"], reduction="mean")

    grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v))
    return dict(sd=sd, batch=batch, jax16=jax_params_to_state_dict(grads, sd))


def _meta_grad(sd, batch, dtype, first_order):
    net = EDVR(**EDVR_L_CUT, dtype=dtype)
    net.load_state_dict(sd)
    params = dict(net.named_parameters())
    outer, _ = meta_loss(net, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                         MetaConfig(inner_lr=ALPHA, first_order=first_order),
                         make_model_apply("EDVR", 4))
    return dict(zip(params, torch.autograd.grad(outer, list(params.values()))))


def test_edvr_l_shaped_bf16_meta_gradient_matches_jax(edvr_l):
    """(e): the port's bf16 second-order meta gradient against JAX's, each
    parameter tensor gauged; a dropped second-order term would miss its
    tensor's tolerance more than 10 x."""
    sd, batch = edvr_l["sd"], edvr_l["batch"]
    p16, p32 = _meta_grad(sd, batch, BF16, False), _meta_grad(sd, batch, None, False)
    p32_first = _meta_grad(sd, batch, None, True)
    worst, term = 0.0, 0.0
    for k, j16 in edvr_l["jax16"].items():
        if k not in p16:
            continue
        tol = 2.0 * float((j16 - p32[k]).norm()) + 1e-3 * float(p32[k].norm())
        worst = max(worst, float((p16[k] - j16).norm()) / tol)
        term = max(term, float((p32[k] - p32_first[k]).norm()) / tol)
    assert len(p16) == len([k for k in edvr_l["jax16"] if k in p16])
    assert worst <= 1.0, worst
    assert term > 10.0, term


def test_meta_model_builds_and_steps_bf16_edvr_and_duf_at_second_order(tmp_path):
    """MetaModel takes a bf16 EDVR and a bf16 DUF to second order (no
    refusal), and one update of each is finite."""
    save_network(str(tmp_path), 0, EDVR(**TINY_EDVR))
    for net, frames in (({"which_model_G": "EDVR", **TINY_EDVR}, 3),
                        ({"which_model_G": "DUF_16L", "nframes": 7}, 7)):
        opt = {"name": "meta", "model": "video_meta", "scale": 4, "is_train": True,
               "network_G": {**net, "dtype": "bfloat16"},
               "path": {"pretrain_model_G": str(tmp_path / "0_G.pth") if frames == 3 else None,
                        "strict_load": True},
               "train": {"lr_G": 1e-4, "lr_scheme": "constant", "maml_lr_alpha": 1e-5,
                         "first_order": False, "pixel_criterion": "cb"}}
        model = create_model(opt, device="cpu")
        assert isinstance(model, MetaModel) and not model.meta_cfg.first_order
        model.feed_data(meta_batches(frames, 1, seed=1)[0])
        model.optimize_parameters(1)
        log = model.get_current_log()
        assert all(np.isfinite(log[k]) for k in ("l_outer", "l_inner", "grad_norm")), log


def test_third_backward_through_bf16_kernels_still_raises(monkeypatch):
    """A third backward through the bf16 Functions raises, as in fp32."""
    _bf16_stand_ins(monkeypatch)
    arrays, _ = _dcn_case(seed=9)
    x, o, m, w = _port_dcn_inputs(arrays, BF16)
    t = o.clone().requires_grad_()
    out = dcn.DeformConv2dFunction.apply(x, t, m, w, None, GD)
    (g,) = torch.autograd.grad(_loss(out) + (t.float() ** 3).sum(), t, create_graph=True)
    with pytest.raises(RuntimeError, match="double backward.*K8-K10.*second-order"):
        torch.autograd.grad(g.float().sum(), t, create_graph=True)
