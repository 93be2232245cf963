"""A double backward through the port's kernel Functions raises, on CPU.

`DeformConv2dFunction` (K1-K3), `WarpFunction` (K4/K5) and
`DufFilterFunction` (K6/K7) fill their gradients through ctypes, so those
gradients carry no graph: a `create_graph=True` gradient through them
would lose every second-order term that passes through a kernel, with no
error. Their backward raises instead. Each case takes
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
  without a graph: the first-order gradient equals the plain op's (1e-6 of
  the largest value: the same arithmetic), and `create_graph=True` raises a
  RuntimeError that names the kernel.
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
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref
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
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
            out = fn(*leaves)
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad_out.detach()))
        return [next(grads) if n else None for n in need]

    if op == "warp":
        monkeypatch.setattr(warp, "warp_fwd", grid_sample_ref.warp_nchw)
        monkeypatch.setattr(warp, "warp_bwd", lambda x, flow, grad_out, need_x: tuple(vjp(
            grid_sample_ref.warp_nchw, (x, flow), (need_x, True), grad_out)))
    elif op == "duf":
        monkeypatch.setattr(duf_filter, "duf_fwd", dynamic_upsampling_filter_ref)
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

        monkeypatch.setattr(dcn, "_fwd", fwd)
        monkeypatch.setattr(dcn, "dcn_bwd_data", bwd_data)
        monkeypatch.setattr(dcn, "dcn_bwd_weight", bwd_weight)


@pytest.mark.parametrize("op", ["dcn", "warp", "duf"])
def test_double_backward_through_the_kernel_function_raises(op, monkeypatch):
    case = _case(op, seed=12)
    _stand_ins(op, monkeypatch)
    t = case["theta"].clone().requires_grad_()
    (got,) = torch.autograd.grad(_loss(case["function"](t), t), t)
    tr = case["theta"].clone().requires_grad_()
    (want,) = torch.autograd.grad(_loss(case["plain"](tr), tr), tr)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))

    t = case["theta"].clone().requires_grad_()
    loss = _loss(case["function"](t), t)
    kernel = {"dcn": "K2", "warp": "K5", "duf": "K7"}[op]
    with pytest.raises(RuntimeError, match=f"double backward.*{kernel}.*second-order"):
        torch.autograd.grad(loss, t, create_graph=True)
