"""Second order through the port's kernel Functions, on CPU.

The kernels fill their gradients through ctypes, so those gradients carry
no graph. Each Function carries its second order through a Function of its
backward kernel: `DeformConv2dFunction` (K1-K3) through
`DcnBwdDataFunction` / `DcnBwdWeightFunction`, whose backward is K1-K3
again plus K8-K10 (ops/dcn.py); `WarpFunction` (K4/K5) through
`WarpBwdFunction`, whose backward is K4/K5 plus K11/K12
(ops/grid_sample.py); `DufFilterFunction` (K6/K7) through
`DufBwdFunction`, whose backward is K6/K7 with their inputs swapped
(ops/duf_filter.py). A third backward raises instead of losing every term
that passes through a kernel. Each case takes
`loss = sum(op(theta)^2) + sum(theta^3)`: theta reaches the loss through the
op and through a plain path, so `torch.autograd.grad(..., inputs=theta)`
still has an edge to theta when the op's gradient has none (a
`@once_differentiable` marker's error node is pruned there, and the term is
dropped silently).

- The plain op's grad-of-grad (`sum(dL/dtheta)` differentiated again)
  matches the JAX package's on the same numpy inputs, and differs from the
  plain path's term alone (6 theta) by far more than the tolerance: a
  dropped term shows. Tolerance: fp32 sums of products in another order,
  1e-4 of the largest reference value.
- Through `Function.apply`, with the ctypes launchers replaced by stand-ins
  built from the plain versions that, like the kernels, return values
  without a graph (K8-K12 by their explicit formulas, ops/dcn_ref.py and
  ops/grid_sample_ref.py): the first-order gradient equals the plain op's
  (1e-6 of the largest value: the same arithmetic), and the grad-of-grad,
  which tests each second-order decomposition, equals plain autograd's
  within 1e-5 of the largest value (fp32 sums in another order); a third
  backward raises a RuntimeError that names the kernels. For the DCN also
  with every input differentiated, with and without a mask
  (test_torch_port_second_order.py does the same for the warp and the
  filter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.models.duf import dynamic_upsampling_filter as jax_duf_filter
from dynavsr_tpu.ops.dcn_fused import deform_conv2d_fused as jax_dcn
from dynavsr_tpu.ops.grid_sample import flow_warp as jax_flow_warp
from dynavsr_tpu_torch.ops import dcn, duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.dcn_ref import (
    dcn_bwd_data_tangent_ref,
    dcn_bwd_weight_tangent_ref,
    dcn_fwd_tangent_ref,
    deform_conv2d_ref,
)
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref

B, C, H, W, R, GD = 2, 3, 6, 7, 4, 2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _case(op, seed):
    """theta (numpy NHWC, torch in the port's layout), a map from the port's
    layout back to NHWC, and three functions of theta with the other inputs
    fixed: the plain torch op, the JAX op (NHWC) and the op through the
    port's autograd Function."""
    rng = np.random.default_rng(seed)
    if op == "warp":  # theta = the flow, (B, H, W, 2) white noise of a few px
        x = rng.standard_normal((B, H, W, C)).astype(np.float32)
        theta = (rng.standard_normal((B, H, W, 2)) * 2.0).astype(np.float32)
        xt = _nchw(x)
        return dict(theta_np=theta, theta=_nchw(theta), to_nhwc=lambda g: np.moveaxis(g, 1, -1),
                    plain=lambda t: grid_sample_ref.warp_nchw(xt, t),
                    jax=lambda t: jax_flow_warp(jnp.asarray(x), t),
                    function=lambda t: warp.WarpFunction.apply(xt, t))
    if op == "duf":  # theta = the filters, (B, H, W, 25, R) raw N(0, 1)
        x = rng.random((B, H, W, C)).astype(np.float32)
        theta = rng.standard_normal((B, H, W, 25, R)).astype(np.float32)
        xt = _nchw(x)
        return dict(theta_np=theta,
                    theta=torch.from_numpy(np.ascontiguousarray(theta.transpose(0, 3, 4, 1, 2))),
                    to_nhwc=lambda g: g.transpose(0, 3, 4, 1, 2),
                    plain=lambda t: dynamic_upsampling_filter_ref(xt, t),
                    jax=lambda t: jax_duf_filter(jnp.asarray(x), t),
                    function=lambda t: duf_filter.DufFilterFunction.apply(xt, t))
    # dcn: theta = the offsets, (B, H, W, 2 Gd 9), non-integer, some taps outside
    x = rng.standard_normal((B, H, W, C * GD)).astype(np.float32)
    theta = (rng.standard_normal((B, H, W, 2 * GD * 9)) * 2.0 + 0.37).astype(np.float32)
    mask = rng.random((B, H, W, GD * 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, C * GD, C)) * 0.2).astype(np.float32)  # HWIO
    bias = rng.standard_normal(C).astype(np.float32)
    xt, mt = _nchw(x), _nchw(mask)
    wt = torch.from_numpy(np.ascontiguousarray(weight.transpose(3, 2, 0, 1)))  # OIHW
    bt = torch.from_numpy(bias)
    return dict(theta_np=theta, theta=_nchw(theta), to_nhwc=lambda g: np.moveaxis(g, 1, -1),
                plain=lambda t: deform_conv2d_ref(xt, t, mt, wt, bt, deformable_groups=GD),
                jax=lambda t: jax_dcn(jnp.asarray(x), t, jnp.asarray(mask), jnp.asarray(weight),
                                      jnp.asarray(bias), deformable_groups=GD),
                function=lambda t: dcn.DeformConv2dFunction.apply(xt, t, mt, wt, bt, GD))


def _loss(op_out, theta):
    return (op_out ** 2).sum() + (theta ** 3).sum()


def _grad_of_grad(fn, theta):
    t = theta.clone().requires_grad_()
    (g,) = torch.autograd.grad(_loss(fn(t), t), t, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), t)
    return gg


@pytest.mark.parametrize("op", ["dcn", "warp", "duf"])
def test_plain_grad_of_grad_matches_jax_and_has_a_term_through_the_op(op):
    case = _case(op, seed=11)

    def loss(t):
        return _loss(case["jax"](t), t)

    theta_np = case["theta_np"]
    want = np.asarray(jax.grad(lambda t: jax.grad(loss)(t).sum())(jnp.asarray(theta_np)))
    got = case["to_nhwc"](_grad_of_grad(case["plain"], case["theta"]).numpy())
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.abs(want - 6.0 * theta_np).max() > 100 * tol


def _stand_ins(op, monkeypatch):
    """Replace the Function's ctypes launchers by the plain versions, which
    return values without a graph, as the kernels do."""
    def vjp(fn, inputs, need, grad_out):
        need = [n and t is not None for t, n in zip(inputs, need)]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            out = fn(*leaves)
            wrt = [t for t in leaves if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out.detach()))
        return [next(grads) if n else None for n in need]

    def detached(fn):
        def call(*args, **kwargs):
            with torch.no_grad():
                out = fn(*args, **kwargs)
            return out.detach() if torch.is_tensor(out) else tuple(
                None if t is None else t.detach() for t in out)
        return call

    if op == "warp":
        monkeypatch.setattr(warp, "warp_fwd", detached(grid_sample_ref.warp_nchw))
        monkeypatch.setattr(warp, "warp_bwd", lambda x, flow, grad_out, need_x: tuple(vjp(
            grid_sample_ref.warp_nchw, (x, flow), (need_x, True), grad_out)))
        monkeypatch.setattr(warp, "warp_fwd_tangent",
                            detached(grid_sample_ref.warp_fwd_tangent_ref))
        monkeypatch.setattr(warp, "warp_bwd_tangent",
                            detached(grid_sample_ref.warp_bwd_tangent_ref))
    elif op == "duf":
        monkeypatch.setattr(duf_filter, "duf_fwd", detached(dynamic_upsampling_filter_ref))
        monkeypatch.setattr(duf_filter, "duf_bwd", lambda x, f, grad_out, need_x: tuple(vjp(
            dynamic_upsampling_filter_ref, (x, f), (need_x, True), grad_out)))
    else:
        def plain(gd):
            return lambda x, o, m, w: deform_conv2d_ref(x, o, m, w, deformable_groups=gd)

        def fwd(x, offset, mask, weight, bias, gd):
            return (deform_conv2d_ref(x, offset, mask, weight, bias, deformable_groups=gd),
                    x.contiguous(memory_format=torch.channels_last))

        def bwd_data(x, offset, mask, weight, grad_out, gd):
            return tuple(vjp(plain(gd), (x, offset, mask, weight), (True, True, True, False),
                             grad_out)[:3])

        def bwd_weight(x, offset, mask, grad_out, gd):
            w = x.new_zeros(grad_out.shape[1], x.shape[1], 3, 3)  # grad weight is linear
            return vjp(plain(gd), (x, offset, mask, w), (False, False, False, True), grad_out)[3]

        monkeypatch.setattr(dcn, "_fwd", detached(fwd))
        monkeypatch.setattr(dcn, "dcn_bwd_data", bwd_data)
        monkeypatch.setattr(dcn, "dcn_bwd_weight", bwd_weight)
        monkeypatch.setattr(dcn, "dcn_fwd_tangent", detached(dcn_fwd_tangent_ref))
        monkeypatch.setattr(dcn, "dcn_bwd_weight_tangent", detached(dcn_bwd_weight_tangent_ref))
        monkeypatch.setattr(dcn, "dcn_bwd_data_tangent", detached(dcn_bwd_data_tangent_ref))


# The kernels a third backward through each Function names.
THIRD = {"dcn": "K8-K10", "warp": "K11, K12", "duf": "K6, K7"}


@pytest.mark.parametrize("op", ["dcn", "warp", "duf"])
def test_double_backward_through_the_kernel_function_raises(op, monkeypatch):
    """The second order through the Function equals plain autograd's; the
    third backward raises."""
    case = _case(op, seed=12)
    _stand_ins(op, monkeypatch)
    t = case["theta"].clone().requires_grad_()
    (got,) = torch.autograd.grad(_loss(case["function"](t), t), t)
    tr = case["theta"].clone().requires_grad_()
    (want,) = torch.autograd.grad(_loss(case["plain"](tr), tr), tr)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))

    got = _grad_of_grad(case["function"], case["theta"])
    want = _grad_of_grad(case["plain"], case["theta"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    t = case["theta"].clone().requires_grad_()
    (g,) = torch.autograd.grad(_loss(case["function"](t), t), t, create_graph=True)
    with pytest.raises(RuntimeError, match=f"double backward.*{THIRD[op]}.*second-order"):
        torch.autograd.grad(g.sum(), t, create_graph=True)


# (Gd, C, H, W, offset scale): today's case; groups of 6 channels at Gd 8
# (off the kernels' 8-channel vector path); white-noise offsets N(0, 4^2)
# px (far samples, corners outside the frame); 4x4 frames (the meta inner
# step's smallest level, where the kernels' tiles hold whole frames).
SECOND_ORDER_CASES = {"default": (2, 4, H, W, 1.5), "cg6": (8, 48, H, W, 1.5),
                      "wide": (2, 4, H, W, 4.0), "frames4x4": (2, 4, 4, 4, 1.5)}


@pytest.mark.parametrize("case,with_mask", [
    pytest.param(case, m, id=("" if case == "default" else f"{case}-") + ("nomask", "mask")[m])
    for case in SECOND_ORDER_CASES for m in (True, False)])
def test_dcn_second_order_in_every_input_matches_plain_autograd(case, with_mask, monkeypatch):
    """Every input of the DCN differentiated (x, offset, mask, weight,
    bias): g = dL/d(inputs) with create_graph, then the gradient of
    sum_i <r_i, g_i> for fixed random r_i, through Function.apply with
    K1-K3 and K8-K10 replaced by their plain versions, against plain
    autograd through deform_conv2d_ref; 1e-5 of the largest value each.
    The launch counts of the stand-ins are not kept: this is the
    arithmetic of the decomposition, and so the plain K8-K10 formulas that
    the card's checks hold the kernels to, on the kernels' edge cases
    (SECOND_ORDER_CASES)."""
    _stand_ins("dcn", monkeypatch)
    rng = np.random.default_rng(5)
    gd, c, h, w, scale = SECOND_ORDER_CASES[case]
    cout = 3
    arrays = [rng.standard_normal((B, c, h, w)),
              rng.standard_normal((B, 2 * gd * 9, h, w)) * scale + (0.37 if scale < 4 else 0.0),
              rng.random((B, gd * 9, h, w)), rng.standard_normal((cout, c, 3, 3)) * 0.3,
              rng.standard_normal(cout)]
    inputs = [torch.tensor(a, dtype=torch.float32) for a in arrays]
    if not with_mask:
        inputs[2] = None
    rs = [None if t is None else torch.tensor(rng.standard_normal(t.shape), dtype=torch.float32)
          for t in inputs]

    def grad_of_grad(fn):
        leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
        wrt = [t for t in leaves if t is not None]
        out = fn(*leaves)
        gs = torch.autograd.grad((out ** 2).sum() + (out ** 3).mean(), wrt, create_graph=True)
        inner = sum((g * r).sum() for g, r in zip(gs, [r for r in rs if r is not None]))
        return torch.autograd.grad(inner, wrt)

    got = grad_of_grad(lambda x, o, m, w, b: dcn.DeformConv2dFunction.apply(x, o, m, w, b, gd))
    want = grad_of_grad(lambda x, o, m, w, b: deform_conv2d_ref(x, o, m, w, b,
                                                                deformable_groups=gd))
    for name, g, w in zip(("x", "offset", "mask", "weight", "bias"), got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * float(w.abs().max()), msg=name)
