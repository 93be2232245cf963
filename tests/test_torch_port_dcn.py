"""The port's plain deformable conv against the JAX package's, on CPU.

Same numpy inputs through dynavsr_tpu_torch.ops.deform_conv2d (NCHW, which
runs dcn_ref on CPU tensors) and through JAX's deform_conv2d_ref and
deform_conv2d_fused (NHWC): forward, and the VJP for x, offset, mask,
weight and bias. Offsets are non-integer and push some samples outside
the image. Tolerance: fp32 throughout, sums over C*K = 72 terms in a
different order, so 1e-4 absolute on O(1) values; the bf16 cases state
theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynavsr_tpu.ops.dcn_fused import deform_conv2d_fused
from dynavsr_tpu.ops.dcn_ref import deform_conv2d_ref
from dynavsr_tpu_torch.ops.dcn import deform_conv2d
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref as torch_dcn_ref

B, C, COUT, H, W = 2, 8, 6, 7, 9
TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(gd, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    # Non-integer offsets up to ~±5 px: many taps land partly or fully
    # outside the 7x9 frame.
    offset = (rng.standard_normal((B, H, W, 2 * gd * 9)) * 2.0 + 0.37).astype(np.float32)
    mask = rng.random((B, H, W, gd * 9)).astype(np.float32)
    weight = (rng.standard_normal((3, 3, C, COUT)) * 0.2).astype(np.float32)  # HWIO
    bias = rng.standard_normal(COUT).astype(np.float32)
    cot = rng.standard_normal((B, H, W, COUT)).astype(np.float32)
    return x, offset, mask, weight, bias, cot


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("jax_fn", [deform_conv2d_ref, deform_conv2d_fused],
                         ids=["ref", "fused"])
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_dcn_forward_and_vjp_match_jax(jax_fn, gd, with_mask):
    x, offset, mask, weight, bias, cot = _inputs(gd, seed=gd)
    m = mask if with_mask else None

    def f(x_, o_, m_, w_, b_):
        return jax_fn(x_, o_, m_, w_, b_, deformable_groups=gd)

    args = [jnp.asarray(a) for a in (x, offset, mask, weight, bias)]
    if not with_mask:
        out_j, vjp = jax.vjp(lambda x_, o_, w_, b_: f(x_, o_, None, w_, b_),
                             args[0], args[1], args[3], args[4])
        gx_j, go_j, gw_j, gb_j = vjp(jnp.asarray(cot))
    else:
        out_j, vjp = jax.vjp(f, *args)
        gx_j, go_j, gm_j, gw_j, gb_j = vjp(jnp.asarray(cot))

    xt = _nchw(x).requires_grad_()
    ot = _nchw(offset).requires_grad_()
    mt = _nchw(mask).requires_grad_() if with_mask else None
    wt = torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()).requires_grad_()  # OIHW
    bt = torch.from_numpy(bias).requires_grad_()
    out_t = deform_conv2d(xt, ot, mt, wt, bt, deformable_groups=gd)
    out_t.backward(_nchw(cot))

    np.testing.assert_allclose(out_t.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx_j), **TOL)
    np.testing.assert_allclose(ot.grad.numpy().transpose(0, 2, 3, 1), np.asarray(go_j),
                               atol=3e-4, rtol=1e-4)
    if with_mask:
        np.testing.assert_allclose(mt.grad.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(gm_j), **TOL)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 1, 0), np.asarray(gw_j),
                               atol=3e-4, rtol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_j), **TOL)


def test_dcn_samples_outside_are_zero():
    """An offset that moves every tap fully outside the frame leaves only
    the bias (each corner outside contributes zero)."""
    x, offset, mask, weight, bias, _ = _inputs(2, seed=7)
    far = np.full_like(offset, 50.5)
    out = deform_conv2d(_nchw(x), _nchw(far), _nchw(mask),
                        torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(bias), deformable_groups=2)
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(bias[None, :, None, None],
                                                            out.shape), atol=1e-6)


def test_dcn_bf16_positions_are_fp32():
    """bf16 inputs: positions are formed in fp32 and the result is returned
    in bf16, within bf16 rounding of the fp32 result (tolerance: the output
    magnitude times 2^-7, two roundings of the inputs and one of the output)."""
    x, offset, mask, weight, bias, _ = _inputs(8, seed=3)
    args = [_nchw(x), _nchw(offset), _nchw(mask),
            torch.from_numpy(weight.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias)]
    ref = deform_conv2d(*[a.to(torch.bfloat16).float() for a in args], deformable_groups=8)
    out = deform_conv2d(*[a.to(torch.bfloat16) for a in args], deformable_groups=8)
    assert out.dtype == torch.bfloat16
    scale = float(ref.abs().max())
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=scale * 2 ** -7)


@pytest.mark.parametrize("gd", [1, 2, 8])
def test_dcn_plain_bf16_matches_jax_fused_bf16(gd):
    """The plain version with bf16 columns and weights (K1's function in
    bf16: `compute_dtype=torch.bfloat16`, which the CPU branch uses for bf16
    inputs) against JAX's deform_conv2d_fused on the same bf16 inputs. Each
    framework rounds at its own points (JAX also rounds the corner weights,
    the per-corner products and the output before adding the bias in bf16),
    and each stays within 2^-7 of the largest fp32 value of the fp32 result
    on the same bf16-valued inputs, so the two agree within 2^-6 of it."""
    x, offset, mask, weight, bias, _ = _inputs(gd, seed=gd)
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, offset, mask, weight, bias)]
    want = np.asarray(deform_conv2d_fused(*[jnp.asarray(a) for a in bf],
                                          deformable_groups=gd)).astype(np.float32)
    want32 = np.asarray(deform_conv2d_fused(*[jnp.asarray(a.astype(np.float32)) for a in bf],
                                            deformable_groups=gd))
    args = [_nchw(a.astype(np.float32)) for a in bf[:3]]
    args += [torch.from_numpy(bf[3].astype(np.float32).transpose(3, 2, 0, 1).copy()),
             torch.from_numpy(bf[4].astype(np.float32))]
    out = deform_conv2d(*[a.to(torch.bfloat16) for a in args], deformable_groups=gd)
    plain = torch_dcn_ref(*args, deformable_groups=gd, compute_dtype=torch.bfloat16)
    out32 = deform_conv2d(*args, deformable_groups=gd)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), plain.to(torch.bfloat16).float().numpy())
    got = out.float().numpy().transpose(0, 2, 3, 1)
    scale = float(np.abs(want32).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2 ** -6 * scale)
    np.testing.assert_allclose(got, want32, rtol=0, atol=2 ** -7 * scale)
    assert not np.array_equal(plain.numpy(), out32.numpy())  # the columns were rounded


@pytest.mark.parametrize("gd", [1, 2, 8])
def test_dcn_plain_bf16_vjp_matches_jax_fused_bf16(gd):
    """The VJP of the port's DCN on bf16 CPU tensors (the plain version with
    bf16 columns and weights: K2's and K3's function in bf16, grad weight
    from the rounded columns) against JAX's deform_conv2d_fused VJP on the
    same bf16 inputs and cotangent, for x, offset, mask and weight. Each
    framework rounds at its own points; each stays within 2 x 2^-7 of the
    largest fp32 gradient on the same bf16-valued inputs (about 1 x 2^-7
    measured), so the two agree within twice that."""
    bf = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in _inputs(gd, seed=gd)]

    def jax_grads(arrs):
        _, vjp = jax.vjp(lambda *a: deform_conv2d_fused(*a, deformable_groups=gd),
                         *[jnp.asarray(a) for a in arrs[:5]])
        return [np.asarray(g).astype(np.float32) for g in vjp(jnp.asarray(arrs[5]))[:4]]

    def port_grads(dtype):
        leaves = [_nchw(a.astype(np.float32)).to(dtype).requires_grad_() for a in bf[:3]]
        leaves.append(torch.from_numpy(bf[3].astype(np.float32).transpose(3, 2, 0, 1).copy())
                      .to(dtype).requires_grad_())
        bias = torch.from_numpy(bf[4].astype(np.float32)).to(dtype)
        deform_conv2d(*leaves, bias, deformable_groups=gd).backward(
            _nchw(bf[5].astype(np.float32)).to(dtype))
        assert all(t.grad.dtype == dtype for t in leaves)
        return [t.grad.float().numpy().transpose(0, 2, 3, 1) for t in leaves[:3]] + [
            leaves[3].grad.float().numpy().transpose(2, 3, 1, 0)]

    want16 = jax_grads(bf)
    got16, got32 = port_grads(torch.bfloat16), port_grads(torch.float32)
    for name, g16, g32, j16 in zip(("x", "offset", "mask", "weight"), got16, got32, want16):
        tol = 2 * 2 ** -7 * float(np.abs(g32).max())
        np.testing.assert_allclose(g16, g32, rtol=0, atol=tol, err_msg=f"port grad {name}")
        np.testing.assert_allclose(j16, g32, rtol=0, atol=tol, err_msg=f"JAX grad {name}")
        np.testing.assert_allclose(g16, j16, rtol=0, atol=2 * tol, err_msg=f"grad {name}")
