"""The CUDA kernels against their plain PyTorch versions, on the card: the
DCN's K1 dcn_fwd, K2 dcn_bwd_data and K3 dcn_bwd_weight (ops/dcn_ref.py),
the bilinear warp's K4 warp_fwd and K5 warp_bwd (ops/grid_sample_ref.py),
and DUF's dynamic upsampling filter K6 duf_fwd and K7 duf_bwd
(ops/duf_filter_ref.py).

Every test here is gpu-marked and skips without a card. This file imports no JAX, so on
the card it runs without the repository's conftest:

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest

Tolerances: fp32 — the kernels and dcn_ref do the same fp32 arithmetic in
another order (atomics in K2/K3 change it from run to run), so 1e-4 of the
largest reference value (TF32 off). bf16 — both sides read the same bf16
inputs; the reference runs in fp32 on them and the kernels round their
fp32 results to bf16 once, so 2^-7 of the largest reference value. Warp
(fp32 only): forward 1e-5 of the largest reference value (the same four
products, maybe fused into FMAs); grad flow and grad x 1e-4 (grad x lands
with atomics, in another order). DUF filter: 1e-5 of the largest
reference value (fp32 sums of 25 or 25 R products in another order); bf16
filters get their gradient rounded to bf16 on both sides, where the same
sum may land one bf16 step apart, so grad filters there 2^-7 of the value
(one step) plus 1e-5 of the largest.
"""

import pytest
import torch

from dynavsr_tpu_torch.ops import dcn, duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.dcn_ref import deform_conv2d_ref
from dynavsr_tpu_torch.ops.duf_filter_ref import dynamic_upsampling_filter_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the DCN kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, c, cout, h, w, gd, device, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    offset = torch.randn(b, 2 * gd * 9, h, w, generator=g) * 2.0 + 0.37
    mask = torch.rand(b, gd * 9, h, w, generator=g)
    weight = torch.randn(cout, c, 3, 3, generator=g) * (1.0 / (c * 9) ** 0.5)
    bias = torch.randn(cout, generator=g)
    cot = torch.randn(b, cout, h, w, generator=g)
    return [t.to(device) for t in (x, offset, mask, weight, bias, cot)]


def _close(got, ref, tol):
    ref = ref.detach().float()
    err = float((got.float() - ref).abs().max())
    bound = tol * max(float(ref.abs().max()), 1e-6)
    assert err <= bound, f"max |err| {err:.3e} > {bound:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 64, 13, 21), (3, 8, 6, 9, 7), (1, 128, 64, 11, 70)],
                         ids=["c64", "c8", "c128"])
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_kernels_match_plain(cuda, shape, gd, dtype, with_mask):
    b, c, cout, h, w = shape
    x, offset, mask, weight, bias, cot = _inputs(b, c, cout, h, w, gd, cuda, seed=gd)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    lo = [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]
    x, offset, mask, weight, bias, cot = lo
    m = mask if with_mask else None

    # Plain version in fp32 on the (possibly bf16-rounded) inputs.
    ref_in = [t.float().requires_grad_() for t in (x, offset, mask, weight, bias)]
    ref = deform_conv2d_ref(ref_in[0], ref_in[1], ref_in[2] if with_mask else None,
                            ref_in[3], ref_in[4], deformable_groups=gd)
    ref.backward(cot.float())

    out = dcn.dcn_fwd(x, offset, m, weight, bias, gd)
    gx, goff, gmask = dcn.dcn_bwd_data(x, offset, m, weight, cot, gd)
    gw = dcn.dcn_bwd_weight(x, offset, m, cot, gd)
    torch.cuda.synchronize()
    assert out.dtype == gx.dtype == goff.dtype == gw.dtype == dtype
    _close(out, ref, tol)
    _close(gx, ref_in[0].grad, tol)
    _close(goff, ref_in[1].grad, tol)
    if with_mask:
        _close(gmask, ref_in[2].grad, tol)
    else:
        assert gmask is None
    _close(gw, ref_in[3].grad, tol)


@pytest.mark.gpu
def test_autograd_goes_through_the_kernels(cuda):
    x, offset, mask, weight, bias, cot = _inputs(2, 16, 16, 8, 12, 2, cuda, seed=0)
    params = [t.requires_grad_() for t in (x, offset, mask, weight, bias)]
    dcn.reset_launch_counts()
    out = dcn.deform_conv2d(*params, deformable_groups=2)
    out.backward(cot)
    assert dcn.launch_counts() == {"dcn_fwd": 1, "dcn_bwd_data": 1, "dcn_bwd_weight": 1}
    ref_in = [t.detach().clone().requires_grad_() for t in params]
    deform_conv2d_ref(*ref_in, deformable_groups=2).backward(cot)
    for got, want in zip(params, ref_in):
        _close(got.grad, want.grad, 1e-4)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, offset, mask, weight, bias, _ = _inputs(1, 16, 16, 8, 8, 2, cuda, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        dcn.dcn_fwd(x.transpose(2, 3), offset, mask, weight, bias, 2)
    with pytest.raises(ValueError, match="dtype"):
        dcn.dcn_fwd(x.double(), offset, mask, weight, bias, 2)
    with pytest.raises(ValueError, match="offset"):
        dcn.dcn_fwd(x, offset[:, :9], mask, weight, bias, 2)
    with pytest.raises(ValueError, match="must be on"):
        dcn.dcn_fwd(x, offset.cpu(), mask, weight, bias, 2)


def _warp_inputs(b, c, h, w, device, seed):
    """White-noise flows N(0, 4^2) px (many samples partly or wholly
    outside the frame), integer on every third row."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g)
    flow = torch.randn(b, 2, h, w, generator=g) * 4.0
    flow[:, :, ::3] = flow[:, :, ::3].round()
    cot = torch.randn(b, c, h, w, generator=g)
    return [t.to(device) for t in (x, flow, cot)]


def _plain_warp_grads(x, flow, cot):
    xr, fr = (t.detach().clone().requires_grad_() for t in (x, flow))
    out = grid_sample_ref.warp_nchw(xr, fr)
    out.backward(cot)
    return out.detach(), xr.grad, fr.grad


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 13, 21), (8, 3, 36, 44), (3, 5, 7, 9), (1, 3, 1, 64)],
                         ids=["c3", "adapt36x44", "c5", "one_row"])
def test_warp_kernels_match_plain(cuda, shape):
    x, flow, cot = _warp_inputs(*shape, cuda, seed=sum(shape))
    ref, ref_gx, ref_gf = _plain_warp_grads(x, flow, cot)
    out = warp.warp_fwd(x, flow)
    gx, gf = warp.warp_bwd(x, flow, cot, need_x=True)
    none, gf_only = warp.warp_bwd(x, flow, cot, need_x=False)
    torch.cuda.synchronize()
    assert none is None
    _close(out, ref, 1e-5)
    _close(gf, ref_gf, 1e-4)
    _close(gx, ref_gx, 1e-4)
    assert torch.equal(gf_only, gf)  # a gather: no atomics, the same order


@pytest.mark.gpu
def test_warp_kernel_far_outside_positions_give_exact_zeros(cuda):
    x, _, cot = _warp_inputs(2, 3, 9, 11, cuda, seed=1)
    flow = torch.zeros(2, 2, 9, 11, device=cuda)
    flow[0, 0], flow[0, 1], flow[1, 0], flow[1, 1] = 1e30, -1e30, -1e30, 3e9
    out = warp.warp_fwd(x, flow)
    gx, gf = warp.warp_bwd(x, flow, cot, need_x=True)
    torch.cuda.synchronize()
    assert not out.any() and not gx.any() and not gf.any()


@pytest.mark.gpu
def test_warp_autograd_goes_through_the_kernels(cuda):
    """Flow needs a gradient, x does not (TOF's adaptation): one K4, one K5,
    no grad x; then both, through the NHWC flow_warp."""
    x, flow, cot = _warp_inputs(2, 3, 8, 12, cuda, seed=4)
    f = flow.clone().requires_grad_()
    warp.reset_launch_counts()
    warp.warp_nchw(x, f).backward(cot)
    assert warp.launch_counts() == {"warp_fwd": 1, "warp_bwd": 1}
    _, ref_gx, ref_gf = _plain_warp_grads(x, flow, cot)
    _close(f.grad, ref_gf, 1e-4)
    xs, fs = (t.permute(0, 2, 3, 1).clone().requires_grad_() for t in (x, flow))
    warp.flow_warp(xs, fs).backward(cot.permute(0, 2, 3, 1))
    assert warp.launch_counts() == {"warp_fwd": 2, "warp_bwd": 2}
    _close(xs.grad.permute(0, 3, 1, 2), ref_gx, 1e-4)
    _close(fs.grad.permute(0, 3, 1, 2), ref_gf, 1e-4)
    with torch.no_grad():
        warp.warp_nchw(x, flow)
    assert warp.launch_counts() == {"warp_fwd": 3, "warp_bwd": 2}


@pytest.mark.gpu
def test_warp_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, flow, cot = _warp_inputs(1, 3, 8, 8, cuda, seed=5)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fwd(x.bfloat16(), flow)
    with pytest.raises(ValueError, match="float32"):
        warp.warp_fwd(x, flow.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        warp.warp_fwd(x.transpose(2, 3), flow)
    with pytest.raises(ValueError, match="does not fit"):
        warp.warp_fwd(x, flow[:, :, :4])
    with pytest.raises(ValueError, match="must be on"):
        warp.warp_fwd(x, flow.cpu())
    with pytest.raises(ValueError, match="grad_out"):
        warp.warp_bwd(x, flow, cot[:, :2], need_x=True)


def _duf_inputs(b, c, r, h, w, fdtype, device, seed):
    """Centre frame U(0, 1), raw N(0, 1) filters (unnormalised: their sums
    cancel, so an error shows), an N(0, 1) output gradient."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.rand(b, c, h, w, generator=g)
    f = torch.randn(b, 25, r, h, w, generator=g).to(fdtype)
    cot = torch.randn(b, c * r, h, w, generator=g)
    return [t.to(device) for t in (x, f, cot)]


def _plain_duf_grads(x, f, cot):
    xr, fr = (t.detach().clone().requires_grad_() for t in (x, f))
    out = dynamic_upsampling_filter_ref(xr, fr)
    out.backward(cot)
    return out.detach(), xr.grad, fr.grad


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 3, 1, 64), (3, 3, 7, 9), (8, 3, 36, 44), (2, 5, 13, 40)],
                         ids=["one_row", "3x7x9", "adapt36x44", "c5"])
@pytest.mark.parametrize("r", [4, 16])
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_duf_kernels_match_plain(cuda, shape, r, fdtype):
    b, c, h, w = shape
    x, f, cot = _duf_inputs(b, c, r, h, w, fdtype, cuda, seed=sum(shape) + r)
    ref, ref_gx, ref_gf = _plain_duf_grads(x, f, cot)
    out = duf_filter.duf_fwd(x, f)
    gx, gf = duf_filter.duf_bwd(x, f, cot, need_x=True)
    none, gf_only = duf_filter.duf_bwd(x, f, cot, need_x=False)
    torch.cuda.synchronize()
    assert none is None and out.dtype == gx.dtype == torch.float32 and gf.dtype == fdtype
    _close(out, ref, 1e-5)
    _close(gx, ref_gx, 1e-5)
    if fdtype == torch.float32:
        _close(gf, ref_gf, 1e-5)
    else:
        torch.testing.assert_close(gf.float(), ref_gf.float(), rtol=2 ** -7,
                                   atol=1e-5 * float(ref_gf.float().abs().max()))
    assert torch.equal(gf_only, gf)  # a gather: no atomics, the same order


@pytest.mark.gpu
def test_duf_autograd_goes_through_the_kernels(cuda):
    """Filters need a gradient, x does not (DUF's adaptation): one K6, one
    K7, no grad x; then both; no launches under no_grad but K6."""
    x, f, cot = _duf_inputs(2, 3, 16, 8, 12, torch.float32, cuda, seed=4)
    fr = f.clone().requires_grad_()
    duf_filter.reset_launch_counts()
    duf_filter.dynamic_upsampling_filter(x, fr).backward(cot)
    assert duf_filter.launch_counts() == {"duf_fwd": 1, "duf_bwd": 1}
    _, ref_gx, ref_gf = _plain_duf_grads(x, f, cot)
    _close(fr.grad, ref_gf, 1e-5)
    xs, fs = (t.clone().requires_grad_() for t in (x, f))
    duf_filter.dynamic_upsampling_filter(xs, fs).backward(cot)
    assert duf_filter.launch_counts() == {"duf_fwd": 2, "duf_bwd": 2}
    _close(xs.grad, ref_gx, 1e-5)
    _close(fs.grad, ref_gf, 1e-5)
    with torch.no_grad():
        duf_filter.dynamic_upsampling_filter(x, f)
    assert duf_filter.launch_counts() == {"duf_fwd": 3, "duf_bwd": 2}


@pytest.mark.gpu
def test_duf_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, f, cot = _duf_inputs(1, 3, 4, 8, 8, torch.float32, cuda, seed=5)
    with pytest.raises(ValueError, match="CUDA"):
        duf_filter.duf_fwd(x.cpu(), f.cpu())
    with pytest.raises(ValueError, match="float32 x"):
        duf_filter.duf_fwd(x.bfloat16(), f)
    with pytest.raises(ValueError, match="filters dtype"):
        duf_filter.duf_fwd(x, f.half())
    with pytest.raises(ValueError, match="contiguous"):
        duf_filter.duf_fwd(x.transpose(2, 3), f)
    with pytest.raises(ValueError, match="do not fit"):
        duf_filter.duf_fwd(x, f[:, :, :, :4])
    with pytest.raises(ValueError, match=r"\(B, 25, R, H, W\)"):
        duf_filter.duf_fwd(x, f[:, :9])
    with pytest.raises(ValueError, match="must be on"):
        duf_filter.duf_fwd(x, f.cpu())
    with pytest.raises(ValueError, match="channels"):
        duf_filter.duf_fwd(torch.zeros(1, 17, 8, 8, device=cuda), f)
    with pytest.raises(ValueError, match="grad_out"):
        duf_filter.duf_bwd(x, f, cot[:, :5], need_x=True)
