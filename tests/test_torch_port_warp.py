"""The port's plain bilinear warp (the K4/K5 kernels' plain version) against
the JAX package's, on CPU.

Same numpy inputs through dynavsr_tpu_torch.ops.grid_sample.flow_warp
(which runs ops/grid_sample_ref.py on CPU tensors) and grid_sample_ref's
grid_sample / bilinear_sample, and through JAX's flow_warp / grid_sample
(the packed `_packed_bilinear`) and bilinear_sample: forward,
and the VJP for x and the flow (or coords). The flows are white noise of a
few pixels, so many samples fall partly or wholly outside the frame, and
some sit exactly on integer positions. Tolerance: fp32, four products a
sample summed in the same order, so 1e-5 of the largest reference value;
against F.grid_sample (which forms its weights from normalised
coordinates) 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dynavsr_tpu.ops.grid_sample import bilinear_sample as jax_bilinear_sample
from dynavsr_tpu.ops.grid_sample import flow_warp as jax_flow_warp
from dynavsr_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from dynavsr_tpu_torch.ops import grid_sample as tgs
from dynavsr_tpu_torch.ops import grid_sample_ref

B, H, W, C = 2, 7, 9, 3


def _inputs(seed, integers=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = (rng.standard_normal((B, H, W, 2)) * 4.0).astype(np.float32)
    if integers:
        # Integer displacements (corner weights exactly 0 / 1) on a third
        # of the pixels, one landing exactly on the last row and column.
        flow[:, ::3] = np.round(flow[:, ::3])
        flow[0, 0, 0] = (W - 1, H - 1)
    cot = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, flow, cot


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


def _torch_vjp(fn, x, pos, cot):
    xt = torch.tensor(x, requires_grad=True)
    pt = torch.tensor(pos, requires_grad=True)
    out = fn(xt, pt)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), xt.grad.numpy(), pt.grad.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_warp_and_vjp_match_jax(seed):
    x, flow, cot = _inputs(seed)
    out_j, vjp = jax.vjp(jax_flow_warp, jnp.asarray(x), jnp.asarray(flow))
    gx_j, gf_j = vjp(jnp.asarray(cot))
    out, gx, gf = _torch_vjp(tgs.flow_warp, x, flow, cot)
    assert (out == 0).any() and (np.asarray(out_j) == 0).any()  # some samples wholly outside
    _close(out, out_j, 1e-5)
    _close(gx, gx_j, 1e-5)
    _close(gf, gf_j, 1e-5)


def test_grid_sample_and_vjp_match_jax():
    """Absolute (y, x) coords to a 5x6 output, beyond the frame on all sides."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    coords = np.stack([rng.uniform(-2.5, H + 1.5, (B, 5, 6)),
                       rng.uniform(-2.5, W + 1.5, (B, 5, 6))], -1).astype(np.float32)
    coords[:, 0] = np.round(coords[:, 0])
    cot = rng.standard_normal((B, 5, 6, C)).astype(np.float32)
    out_j, vjp = jax.vjp(jax_grid_sample, jnp.asarray(x), jnp.asarray(coords))
    gx_j, gc_j = vjp(jnp.asarray(cot))
    out, gx, gc = _torch_vjp(grid_sample_ref.grid_sample, x, coords, cot)
    _close(out, out_j, 1e-5)
    _close(gx, gx_j, 1e-5)
    _close(gc, gc_j, 1e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((H, W, C)).astype(np.float32)
    ys = rng.uniform(-2, H + 1, (4, 5)).astype(np.float32)
    xs = rng.uniform(-2, W + 1, (4, 5)).astype(np.float32)
    ours = grid_sample_ref.bilinear_sample(*(torch.from_numpy(a) for a in (img, ys, xs)))
    ref = jax_bilinear_sample(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))
    assert ours.shape == ref.shape == (4, 5, C)
    _close(ours.numpy(), ref, 1e-5)


def _torch_grid_sample_warp(x, flow):
    """The library yardstick (tests/torch_replicas.py:flow_warp) in NHWC:
    F.grid_sample(bilinear, zeros, align_corners=True) on coordinates
    normalised as 2 v / (size - 1) - 1."""
    xn, fn = x.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    vy, vx = grid_sample_ref.flow_grid(fn)
    grid = torch.stack((2.0 * vx / (W - 1) - 1.0, 2.0 * vy / (H - 1) - 1.0), dim=3)
    out = F.grid_sample(xn, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1)


def test_flow_warp_matches_torch_grid_sample():
    """Off the integer positions: there the gradient is one-sided, and
    F.grid_sample's normalised coordinates may round to the other side."""
    x, flow, cot = _inputs(4, integers=False)
    ours = _torch_vjp(tgs.flow_warp, x, flow, cot)
    lib = _torch_vjp(_torch_grid_sample_warp, x, flow, cot)
    for a, b in zip(ours, lib):
        _close(a, b, 1e-4)


def test_far_outside_positions_give_exact_zeros():
    """Positions up to +-1e30 (past any int) and just outside the border:
    zero output, zero gradients, no overflow."""
    x, _, cot = _inputs(5)
    flow = np.zeros((B, H, W, 2), np.float32)
    flow[0, ..., 0], flow[0, ..., 1] = 1e30, -1e30
    flow[1, ..., 0] = -1e30
    flow[1, :, :, 1] = 3e9
    out, gx, gf = _torch_vjp(tgs.flow_warp, x, flow, cot)
    assert np.array_equal(out, np.zeros_like(out))
    assert not gx.any() and not gf.any()
    # Just past the last column: the x0 corner is in, the x1 corner out.
    edge = np.zeros((B, H, W, 2), np.float32)
    edge[..., 0] = (W - 1) - np.arange(W, dtype=np.float32) + 0.25
    out, _, _ = _torch_vjp(tgs.flow_warp, x, edge, cot)
    np.testing.assert_allclose(out, 0.75 * np.repeat(x[:, :, -1:], W, axis=2), atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, flow, _ = _inputs(6)
    tgs.reset_launch_counts()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    ft = torch.from_numpy(flow).permute(0, 3, 1, 2).contiguous()
    out = tgs.warp_nchw(xt, ft)
    np.testing.assert_array_equal(out.numpy(), grid_sample_ref.warp_nchw(xt, ft).numpy())
    assert tgs.launch_counts() == {"warp_fwd": 0, "warp_bwd": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tgs.warp_fwd(xt, ft)
    with pytest.raises(ValueError, match="CUDA"):
        tgs.warp_bwd(xt, ft, xt, need_x=True)
