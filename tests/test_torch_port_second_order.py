"""The second order of the warp (K4 / K5 with K11 / K12) and of the dynamic
filter (K6 / K7 composed), on CPU.

- K11 / K12's plain formulas (ops/grid_sample_ref.py: warp_fwd_tangent_ref,
  warp_bwd_tangent_ref) against torch's own derivatives of the plain warp
  `warp_nchw` in float64: the tangent forward against `torch.func.jvp`, the
  gradient of <cflow, grad flow> in flow and x against double autograd,
  both within 1e-10 of the largest value (the same products in another
  order), on white-noise flows of a few pixels that reach outside the
  frame.
- Through `Function.apply` (`WarpFunction`, `DufFilterFunction`) with the
  launchers replaced by plain stand-ins (test_torch_port_double_backward.py's)
  on float64 inputs: every input differentiated (x and flow; x and
  filters), g = dL/d(inputs) with create_graph, then the gradient of
  sum_i <r_i, g_i> for fixed random r_i: it equals plain autograd's within
  1e-10 of the largest value (the same float64 products summed in another
  order), so each term of the decompositions in ops/grid_sample.py and
  ops/duf_filter.py is there; and a third backward raises.
- The filter's second order with bf16 filters (DUF's bf16 mode; x fp32)
  through `DufFilterFunction` with the same stand-ins equals plain autograd
  of the plain filter on the same bf16 filters within 2^-7 of the largest
  value (the gradient in the filters is rounded to bf16 on both sides, so
  the same sum may land one bf16 step apart), and a third backward raises.
"""

import numpy as np
import pytest
import torch

from dynavsr_tpu_torch.ops import duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref
from test_torch_port_double_backward import _stand_ins

B, C, H, W, R = 2, 3, 6, 7, 4


def _warp_inputs(seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.tensor(a, dtype=dtype) for a in (
        rng.standard_normal((B, C, H, W)), rng.standard_normal((B, 2, H, W)) * 2.0,
        rng.standard_normal((B, 2, H, W)), rng.standard_normal((B, C, H, W)))]


def test_warp_fwd_tangent_ref_is_the_jvp_of_the_warp():
    x, flow, cflow, _ = _warp_inputs(0)
    _, want = torch.func.jvp(lambda f: grid_sample_ref.warp_nchw(x, f), (flow,), (cflow,))
    got = grid_sample_ref.warp_fwd_tangent_ref(x, flow, cflow)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * float(want.abs().max()))


@pytest.mark.parametrize("need_x", [True, False], ids=["grad_x", "flow_only"])
def test_warp_bwd_tangent_ref_is_the_double_backward_of_the_warp(need_x):
    x, flow, cflow, grad_out = _warp_inputs(1)
    xr, fr = x.clone().requires_grad_(), flow.clone().requires_grad_()
    (gflow,) = torch.autograd.grad(grid_sample_ref.warp_nchw(xr, fr), fr, grad_out,
                                   create_graph=True)
    want_x, want_flow = torch.autograd.grad((gflow * cflow).sum(), [xr, fr])
    got_x, got_flow = grid_sample_ref.warp_bwd_tangent_ref(x, flow, grad_out, cflow, need_x)
    top = max(float(want_x.abs().max()), float(want_flow.abs().max()))
    torch.testing.assert_close(got_flow, want_flow, rtol=0, atol=1e-10 * top)
    if need_x:
        torch.testing.assert_close(got_x, want_x, rtol=0, atol=1e-10 * top)
    else:
        assert got_x is None
    assert float(want_flow.abs().max()) > 0 and float(want_x.abs().max()) > 0


def _every_input(op, seed):
    """(inputs, the Function, the plain op) with every input a float tensor
    that is differentiated."""
    rng = np.random.default_rng(seed)
    if op == "warp":
        x, flow, _, _ = _warp_inputs(seed)
        return [x, flow], warp.WarpFunction.apply, grid_sample_ref.warp_nchw
    x = torch.tensor(rng.random((B, C, H, W)), dtype=torch.float64)
    f = torch.tensor(rng.standard_normal((B, 25, R, H, W)), dtype=torch.float64)
    return [x, f], duf_filter.DufFilterFunction.apply, dynamic_upsampling_filter_ref


@pytest.mark.parametrize("op", ["warp", "duf"])
def test_second_order_in_every_input_matches_plain_autograd(op, monkeypatch):
    _stand_ins(op, monkeypatch)
    inputs, function, plain = _every_input(op, seed=5)
    rng = np.random.default_rng(6)
    rs = [torch.tensor(rng.standard_normal(t.shape), dtype=torch.float64) for t in inputs]

    def grad_of_grad(fn, create_graph=False):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        gs = torch.autograd.grad((out ** 2).sum() + (out ** 3).mean(), leaves, create_graph=True)
        inner = sum((g * r).sum() for g, r in zip(gs, rs))
        return torch.autograd.grad(inner, leaves, create_graph=create_graph)

    got, want = grad_of_grad(function), grad_of_grad(plain)
    for name, g, w in zip(("x", "second"), got, want):
        assert float(w.abs().max()) > 0
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10 * float(w.abs().max()), msg=name)
    with pytest.raises(RuntimeError, match="double backward.*second-order"):
        grad_of_grad(function, create_graph=True)


def test_duf_second_order_in_bf16_matches_plain_autograd(monkeypatch):
    _stand_ins("duf", monkeypatch)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.random((B, C, H, W)), dtype=torch.float32)
    f = torch.tensor(rng.standard_normal((B, 25, R, H, W)), dtype=torch.bfloat16)

    def grad_of_grad(fn, create_graph=False):
        t = f.clone().requires_grad_()
        (g,) = torch.autograd.grad((fn(x, t) ** 2).sum(), t, create_graph=True)
        return torch.autograd.grad(g.float().sum(), t, create_graph=create_graph)[0]

    got = grad_of_grad(duf_filter.DufFilterFunction.apply)
    want = grad_of_grad(dynamic_upsampling_filter_ref)
    assert got.dtype == torch.bfloat16 and float(want.float().abs().max()) > 0
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -7 * float(want.float().abs().max()))
    with pytest.raises(RuntimeError, match="double backward.*K6, K7.*second-order"):
        grad_of_grad(duf_filter.DufFilterFunction.apply, create_graph=True)
