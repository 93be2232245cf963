"""The CUDA kernels against their plain PyTorch versions, on the card: the
DCN's K1 dcn_fwd, K2 dcn_bwd_data and K3 dcn_bwd_weight (ops/dcn_ref.py),
the terms of its second order along an offset cotangent, K8
dcn_fwd_tangent, K9 dcn_bwd_weight_tangent and K10 dcn_bwd_data_tangent
(ops/dcn_ref.py's *_tangent_ref, fp32 only),
the bilinear warp's K4 warp_fwd and K5 warp_bwd (ops/grid_sample_ref.py)
and its second order's K11 warp_fwd_tangent and K12 warp_bwd_tangent,
one kernel (grid_sample_ref's *_tangent_ref), and DUF's dynamic upsampling filter K6
duf_fwd and K7 duf_bwd (ops/duf_filter_ref.py).

Every test here is gpu-marked and skips without a card. This file imports no JAX, so on
the card it runs without the repository's conftest:

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest

Tolerances: fp32 — the kernels and dcn_ref do the same fp32 arithmetic in
another order (atomics in K2/K3 change it from run to run), so 1e-4 of the
largest reference value (TF32 off). bf16 — both sides read the same bf16
inputs; the reference runs in fp32 on them, K1 and K3 round their columns
to bf16 for the tensor cores, and all three round their fp32 results to
bf16 once, so 2^-7 of the largest reference value. In bf16 the kernels
are also held against the plain version with bf16 columns and weights
(`compute_dtype=torch.bfloat16`, their own function): there only the
summation order and the final rounding differ, so 2^-8 for K1, and 2^-8
plus the fp32 tolerance for K2 and K3, whose atomics sum in any order. Warp
(fp32 only): forward 1e-5 of the largest reference value (the same four
products, maybe fused into FMAs); grad flow and grad x 1e-4 (grad x lands
with atomics, in another order); K11 1e-5, K12 1e-4 (a sum over channels,
grad x by atomics). DUF filter: 1e-5 of the largest
reference value (fp32 sums of 25 or 25 R products in another order); bf16
filters get their gradient rounded to bf16 on both sides, where the same
sum may land one bf16 step apart, so grad filters there 2^-7 of the value
(one step) plus 1e-5 of the largest.
"""

import pytest
import torch

from dynavsr_tpu_torch.ops import dcn, duf_filter, grid_sample_ref
from dynavsr_tpu_torch.ops import grid_sample as warp
from dynavsr_tpu_torch.ops.dcn_ref import (
    dcn_bwd_data_tangent_ref,
    dcn_bwd_weight_tangent_ref,
    dcn_fwd_tangent_ref,
    deform_conv2d_ref,
)
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


def _plain_grads(x, offset, mask, weight, bias, cot, gd, compute_dtype=None):
    """The plain version's output and gradients (x, offset, mask, weight) in
    fp32 on the (possibly bf16-rounded) inputs; mask may be None."""
    ref_in = [None if t is None else t.float().requires_grad_()
              for t in (x, offset, mask, weight, bias)]
    ref = deform_conv2d_ref(*ref_in, deformable_groups=gd, compute_dtype=compute_dtype)
    ref.backward(cot.float())
    return ref.detach(), [None if t is None else t.grad for t in ref_in[:4]]


# EDVR's adaptation calls (40 SLR frames at the three pyramid levels) and
# small shapes for the edges: C < 8, C = 128 (two chunks; at Gd 1 a group
# spans both), 4 frames of 92x132 (a persistent walk of many tiles).
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 64, 64, 13, 21), (3, 8, 6, 9, 7), (1, 128, 64, 11, 70),
                                   (3, 64, 64, 92, 132), (40, 64, 64, 36, 44),
                                   (40, 64, 64, 18, 22), (40, 64, 64, 9, 11)],
                         ids=["c64", "c8", "c128", "c64_walk", "adapt36x44", "adapt18x22",
                              "adapt9x11"])
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_kernels_match_plain(cuda, shape, gd, dtype, with_mask):
    b, c, cout, h, w = shape
    x, offset, mask, weight, bias, cot = _inputs(b, c, cout, h, w, gd, cuda, seed=gd)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    x, offset, mask, weight, bias, cot = [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]
    m = mask if with_mask else None
    ref, (rgx, rgoff, rgmask, rgw) = _plain_grads(x, offset, m, weight, bias, cot, gd)

    out = dcn.dcn_fwd(x, offset, m, weight, bias, gd)
    gx, goff, gmask = dcn.dcn_bwd_data(x, offset, m, weight, cot, gd)
    gw = dcn.dcn_bwd_weight(x, offset, m, cot, gd)
    torch.cuda.synchronize()
    assert out.dtype == gx.dtype == goff.dtype == gw.dtype == dtype
    got = [out, gx, goff, gw] + ([gmask] if with_mask else [])
    want = [ref, rgx, rgoff, rgw] + ([rgmask] if with_mask else [])
    for g, r in zip(got, want):
        _close(g, r, tol)
    if not with_mask:
        assert gmask is None
    if dtype == torch.bfloat16:
        # Each kernel's own function: the plain version with bf16 columns
        # and weights. K1 differs from it by summation order and one
        # rounding of its output (2^-8); K2 and K3 by one rounding of each
        # gradient (2^-8 of a value) plus the fp32 summation order of the
        # scatter and the flush (the fp32 tolerance, 1e-4).
        ref16, grads16 = _plain_grads(x, offset, m, weight, bias, cot, gd,
                                      compute_dtype=torch.bfloat16)
        _close(out, ref16, 2 ** -8)
        for g, r in zip([gx, goff, gmask, gw], grads16):
            if r is not None:
                _close(g, r, 2 ** -8 + 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(40, 64, 64, 36, 44), (1, 128, 64, 11, 70)],
                         ids=["adapt36x44", "c128"])
@pytest.mark.parametrize("gd", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_bwd_data_near_offsets(cuda, shape, gd, dtype):
    """Offsets within a pixel of their tap, as EDVR's are: K2 gathers such
    samples' grad x inside a tile and adds only the corners that land in
    another tile with atomics (the wide offsets above are mostly far)."""
    b, c, cout, h, w = shape
    x, offset, mask, weight, bias, cot = _inputs(b, c, cout, h, w, gd, cuda, seed=7)
    offset = (offset - 0.37) * 0.15  # N(0, 0.3^2) pixels
    x, offset, mask, weight, bias, cot = [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]
    _, (rgx, rgoff, rgmask, _) = _plain_grads(x, offset, mask, weight, bias, cot, gd)
    gx, goff, gmask = dcn.dcn_bwd_data(x, offset, mask, weight, cot, gd)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for g, r in zip([gx, goff, gmask], [rgx, rgoff, rgmask]):
        _close(g, r, tol)
    if dtype == torch.bfloat16:
        _, grads16 = _plain_grads(x, offset, mask, weight, bias, cot, gd,
                                  compute_dtype=torch.bfloat16)
        for g, r in zip([gx, goff, gmask], grads16):
            _close(g, r, 2 ** -8 + 1e-4)


# Supervised training of EDVR-M (train_EDVR_M_REDS.yml / train_EDVR_M_TPU.yml):
# batch 32 x 5 frames through PCD, so 160 rows of 64x64 at L1 (and the
# cascade), 10x the pixels of the adaptation calls above.
@pytest.mark.gpu
@pytest.mark.parametrize("gd,dtype", [(8, torch.float32), (2, torch.bfloat16)],
                         ids=["Gd8-fp32", "Gd2-bf16"])
@pytest.mark.parametrize("offsets", ["wide", "near"])
def test_kernels_match_plain_at_the_training_shape(cuda, gd, dtype, offsets):
    """K1, K2 and K3 at 160x64x64x64 against the plain version, wide
    (N(0.37, 2^2) px) and near (N(0, 0.3^2) px, EDVR's kind) offsets, at
    the tolerances above."""
    x, offset, mask, weight, bias, cot = _inputs(160, 64, 64, 64, 64, gd, cuda, seed=11)
    if offsets == "near":
        offset = (offset - 0.37) * 0.15
    x, offset, mask, weight, bias, cot = [t.to(dtype) for t in (x, offset, mask, weight, bias, cot)]
    ref, want = _plain_grads(x, offset, mask, weight, bias, cot, gd)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got = [dcn.dcn_fwd(x, offset, mask, weight, bias, gd),
           *dcn.dcn_bwd_data(x_cl, offset, mask, weight, cot, gd),
           dcn.dcn_bwd_weight(x_cl, offset, mask, cot, gd)]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for g, r in zip(got, [ref, *want[:3], want[3]]):
        _close(g, r, tol)
    if dtype == torch.bfloat16:
        ref16, grads16 = _plain_grads(x, offset, mask, weight, bias, cot, gd,
                                      compute_dtype=torch.bfloat16)
        _close(got[0], ref16, 2 ** -8)
        for g, r in zip(got[1:], [*grads16[:3], grads16[3]]):
            _close(g, r, 2 ** -8 + 1e-4)


# A first-order forward and backward: K1-K3 once each, none of K8-K10.
FIRST_ORDER_LAUNCHES = {"dcn_fwd": 1, "dcn_bwd_data": 1, "dcn_bwd_weight": 1,
                        "dcn_fwd_tangent": 0, "dcn_bwd_weight_tangent": 0,
                        "dcn_bwd_data_tangent": 0}


@pytest.mark.gpu
def test_autograd_goes_through_the_kernels(cuda):
    x, offset, mask, weight, bias, cot = _inputs(2, 16, 16, 8, 12, 2, cuda, seed=0)
    params = [t.requires_grad_() for t in (x, offset, mask, weight, bias)]
    dcn.reset_launch_counts()
    out = dcn.deform_conv2d(*params, deformable_groups=2)
    out.backward(cot)
    assert dcn.launch_counts() == FIRST_ORDER_LAUNCHES
    ref_in = [t.detach().clone().requires_grad_() for t in params]
    deform_conv2d_ref(*ref_in, deformable_groups=2).backward(cot)
    for got, want in zip(params, ref_in):
        _close(got.grad, want.grad, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_channels_last_x_gives_the_nchw_result(cuda, dtype):
    """A channels-last x (a conv may hand one over) is the layout K1
    gathers from, so its launcher skips the copy: the output equals that of
    the same x in NCHW bit for bit, and the gradients agree up to the order
    of K2/K3's atomics (fp32 1e-4; bf16 one rounding, 2^-8)."""
    x, offset, mask, weight, bias, cot = [
        t.to(dtype) for t in _inputs(2, 64, 64, 13, 21, 8, cuda, seed=4)]
    tol = 1e-4 if dtype == torch.float32 else 2 ** -8
    runs = []
    for xin in (x, x.contiguous(memory_format=torch.channels_last)):
        params = [t.clone().requires_grad_() for t in (xin, offset, mask, weight, bias)]
        dcn.reset_launch_counts()
        out = dcn.deform_conv2d(*params, deformable_groups=8)
        out.backward(cot)
        assert dcn.launch_counts() == FIRST_ORDER_LAUNCHES
        runs.append((out.detach(), [t.grad for t in params]))
    assert runs[1][0].is_contiguous()
    assert torch.equal(runs[0][0], runs[1][0])
    for got, want in zip(runs[1][1], runs[0][1]):
        _close(got, want, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_samples_all_outside_give_exact_zeros(cuda, dtype):
    """Every tap lands outside the frame: no column, no scatter, so grad x
    and grad weight are exactly 0 (and so are the offset and mask
    gradients, whose corners are all outside)."""
    x, offset, mask, weight, bias, cot = [
        t.to(dtype) for t in _inputs(40, 64, 64, 9, 11, 8, cuda, seed=3)]
    far = torch.full_like(offset, 50.5)
    gx, goff, gmask = dcn.dcn_bwd_data(x, far, mask, weight, cot, 8)
    gw = dcn.dcn_bwd_weight(x, far, mask, cot, 8)
    torch.cuda.synchronize()
    for t in (gx, goff, gmask, gw):
        assert not t.any()


@pytest.mark.gpu
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_offset_and_mask_gradients_are_deterministic(cuda, gd, dtype):
    """grad offset and grad mask are summed without atomics: two runs give
    the same bits (grad x and grad weight take atomics, in any order)."""
    x, offset, mask, weight, _, cot = [
        t.to(dtype) for t in _inputs(40, 64, 64, 36, 44, gd, cuda, seed=5)]
    _, goff1, gmask1 = dcn.dcn_bwd_data(x, offset, mask, weight, cot, gd)
    _, goff2, gmask2 = dcn.dcn_bwd_data(x, offset, mask, weight, cot, gd)
    torch.cuda.synchronize()
    assert torch.equal(goff1, goff2) and torch.equal(gmask1, gmask2)


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
@pytest.mark.parametrize("shape", [(2, 3, 13, 21), (8, 3, 36, 44), (3, 5, 7, 9), (1, 3, 1, 64),
                                   (2, 3, 24, 704), (8, 3, 18, 22), (8, 3, 72, 88),
                                   (8, 3, 144, 176), (2, 3, 9, 1)],
                         ids=["c3", "adapt36x44", "c5", "one_row", "w704", "adapt18x22",
                              "adapt72x88", "adapt144x176", "w1"])
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
def test_warp_bwd_takes_views_at_an_odd_offset(cuda):
    """K5 reads flow and grad_out as float2 only where they are 8-byte
    aligned: contiguous views that start one float into their storage take
    the scalar path and give the same values."""
    x, flow, cot = _warp_inputs(2, 3, 12, 22, cuda, seed=6)
    shifted = [torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape).copy_(t)
               for t in (flow, cot)]
    _, gf = warp.warp_bwd(x, flow, cot, need_x=False)
    _, gf_shifted = warp.warp_bwd(x, *shifted, need_x=False)
    torch.cuda.synchronize()
    assert torch.equal(gf_shifted, gf)


@pytest.mark.gpu
def test_warp_kernel_far_outside_positions_give_exact_zeros(cuda):
    x, _, cot = _warp_inputs(2, 3, 9, 11, cuda, seed=1)
    flow = torch.zeros(2, 2, 9, 11, device=cuda)
    flow[0, 0], flow[0, 1], flow[1, 0], flow[1, 1] = 1e30, -1e30, -1e30, 3e9
    out = warp.warp_fwd(x, flow)
    gx, gf = warp.warp_bwd(x, flow, cot, need_x=True)
    tangent = warp.warp_fwd_tangent(x, flow, torch.ones_like(flow))
    tx, tf, tt = warp.warp_bwd_tangent(x, flow, cot, torch.ones_like(flow), need_x=True,
                                       need_t=True)
    torch.cuda.synchronize()
    assert not out.any() and not gx.any() and not gf.any()
    assert not tangent.any() and not tx.any() and not tf.any() and not tt.any()


# TOF's meta-training warps (8 windows x 3 channels at the inner step's 64x64
# and the outer 256x256, SpyNet's coarser levels) and small edge shapes (odd
# widths take the scalar path).
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 3, 64, 64), (8, 3, 256, 256), (8, 3, 8, 8),
                                   (2, 3, 13, 21), (3, 5, 7, 9), (2, 3, 9, 1)],
                         ids=["meta64", "meta256", "meta8", "c3", "c5", "w1"])
@pytest.mark.parametrize("need_x", [True, False], ids=["grad_x", "flow_only"])
def test_warp_tangent_kernels_match_plain(cuda, shape, need_x):
    """The K11 / K12 kernel against the explicit plain formulas on
    white-noise flows (some on integer positions) and tangents, in each of
    its modes: T alone (warp_fwd_tangent), the gradients alone, both in one
    launch. T within 1e-5 of the largest reference value (the same
    products), the gradients 1e-4 (a sum over channels; grad x by
    atomics)."""
    x, flow, cot = _warp_inputs(*shape, cuda, seed=sum(shape) + 1)
    g = torch.Generator(device="cpu").manual_seed(9)
    cflow = torch.randn(flow.shape, generator=g).to(cuda)
    want_t = grid_sample_ref.warp_fwd_tangent_ref(x, flow, cflow)
    want_gx, want_gf = grid_sample_ref.warp_bwd_tangent_ref(x, flow, cot, cflow, need_x)
    got = warp.warp_fwd_tangent(x, flow, cflow)
    _close(got, want_t, 1e-5)
    for need_t in (False, True):
        gx, gf, t = warp.warp_bwd_tangent(x, flow, cot, cflow, need_x=need_x, need_t=need_t)
        torch.cuda.synchronize()
        _close(gf, want_gf, 1e-4)
        assert (gx is None) == (not need_x) and (t is None) == (not need_t)
        if need_x:
            _close(gx, want_gx, 1e-4)
        if need_t:
            _close(t, want_t, 1e-5)


@pytest.mark.gpu
def test_warp_autograd_goes_through_the_kernels(cuda):
    """Flow needs a gradient, x does not (TOF's adaptation): one K4, one K5,
    no grad x; then both, through the NHWC flow_warp."""
    x, flow, cot = _warp_inputs(2, 3, 8, 12, cuda, seed=4)
    f = flow.clone().requires_grad_()
    warp.reset_launch_counts()
    warp.warp_nchw(x, f).backward(cot)
    first = {"warp_fwd_tangent": 0, "warp_bwd_tangent": 0}
    assert warp.launch_counts() == {"warp_fwd": 1, "warp_bwd": 1, **first}
    _, ref_gx, ref_gf = _plain_warp_grads(x, flow, cot)
    _close(f.grad, ref_gf, 1e-4)
    xs, fs = (t.permute(0, 2, 3, 1).clone().requires_grad_() for t in (x, flow))
    warp.flow_warp(xs, fs).backward(cot.permute(0, 2, 3, 1))
    assert warp.launch_counts() == {"warp_fwd": 2, "warp_bwd": 2, **first}
    _close(xs.grad.permute(0, 3, 1, 2), ref_gx, 1e-4)
    _close(fs.grad.permute(0, 3, 1, 2), ref_gf, 1e-4)
    with torch.no_grad():
        warp.warp_nchw(x, flow)
    assert warp.launch_counts() == {"warp_fwd": 3, "warp_bwd": 2, **first}


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
@pytest.mark.parametrize("shape", [(1, 3, 1, 64), (3, 3, 7, 9), (8, 3, 36, 44), (2, 5, 13, 40),
                                   (2, 1, 9, 12), (1, 16, 10, 23)],
                         ids=["one_row", "3x7x9", "adapt36x44", "c5", "c1", "c16_odd_w"])
@pytest.mark.parametrize("r", [1, 3, 4, 16])
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
@pytest.mark.parametrize("fdtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_duf_bwd_takes_a_gradient_at_an_odd_offset(cuda, fdtype):
    """K7 reads the gradient as float2 only where it is 8-byte aligned: a
    contiguous view that starts one float into its storage takes the
    scalar path and gives the same values."""
    x, f, cot = _duf_inputs(2, 3, 16, 12, 22, fdtype, cuda, seed=6)
    shifted = torch.empty(cot.numel() + 1, device=cuda)[1:].view(cot.shape).copy_(cot)
    _, gf = duf_filter.duf_bwd(x, f, cot, need_x=False)
    _, gf_shifted = duf_filter.duf_bwd(x, f, shifted, need_x=False)
    torch.cuda.synchronize()
    assert torch.equal(gf_shifted, gf)


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


# The meta inner step's DCN calls (8 windows x 5 frames of SLR 16x16 at the
# pyramid's three levels, Gd 8) and small edge shapes (C < 8, C = 128, one
# pixel tile past a tile's end; C = 48, whose groups at Gd 8 (6 channels)
# miss the 8-channel vector path, on a 13x21 frame, a multiple neither of 4
# pixels nor of a tile; a batch of 3 frames of 4x4, less than one tile;
# frames of 5x5 and 5x3, whose H * W is no multiple of 4, so the tiles that
# run across frames (K8, K9) pad each frame and straddle frames, on the
# vector path and, with C = 16 at Gd 8, off it).
TANGENT_SHAPES = {"meta16": (40, 64, 64, 16, 16), "meta8": (40, 64, 64, 8, 8),
                  "meta4": (40, 64, 64, 4, 4), "small": (3, 8, 6, 9, 7),
                  "wide": (1, 128, 64, 11, 3), "c48": (2, 48, 48, 13, 21),
                  "subtile": (3, 64, 64, 4, 4), "pad5": (40, 64, 64, 5, 5),
                  "pad5c16": (7, 16, 16, 5, 3)}


def _tangent_inputs(shape, gd, offsets, device):
    """x, offset, mask, weight, grad_out and the offset cotangent coff.
    Offsets: "noise" N(0.37, 2^2) px (many samples partly outside the
    frame), "smooth" (a bilinearly upsampled coarse field of a fraction of a
    pixel, as trained offsets are: most samples inside), "wide" N(0, 4^2)
    px (far samples, corners out of the frame)."""
    b, c, cout, h, w = shape
    x, offset, mask, weight, _, cot = _inputs(b, c, cout, h, w, gd, device, seed=23)
    g = torch.Generator(device="cpu").manual_seed(24)
    if offsets == "smooth":
        coarse = torch.randn(b, 2 * gd * 9, max(1, h // 4), max(1, w // 4), generator=g) * 0.6
        offset = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                                 align_corners=False).to(device).contiguous()
    elif offsets == "wide":
        offset = (torch.randn(offset.shape, generator=g) * 4.0).to(device)
    coff = torch.randn(offset.shape, generator=g).to(device)
    return x, offset, mask, weight, cot, coff


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(TANGENT_SHAPES.values()), ids=list(TANGENT_SHAPES))
@pytest.mark.parametrize("gd", [1, 2, 8])
@pytest.mark.parametrize("offsets", ["noise", "smooth", "wide"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_tangent_kernels_match_plain(cuda, shape, gd, offsets, with_mask):
    """K8-K10 against their explicit plain formulas, fp32, 1e-4 of the
    largest reference value (the same products in another order; K9 and
    K10 sum with atomics)."""
    b, c, cout, h, w = shape
    if c % gd:
        pytest.skip("channels not divisible by the groups")
    x, offset, mask, weight, cot, coff = _tangent_inputs(shape, gd, offsets, cuda)
    if not with_mask:
        mask = None
    got = dcn.dcn_fwd_tangent(x, offset, mask, weight, coff, gd)
    _close(got, dcn_fwd_tangent_ref(x, offset, mask, weight, coff, gd), 1e-4)
    got = dcn.dcn_bwd_weight_tangent(x, offset, mask, cot, coff, gd)
    _close(got, dcn_bwd_weight_tangent_ref(x, offset, mask, cot, coff, gd), 1e-4)
    got = dcn.dcn_bwd_data_tangent(x, offset, mask, weight, cot, coff, gd)
    want = dcn_bwd_data_tangent_ref(x, offset, mask, weight, cot, coff, gd)
    for gt, wt in zip(got, want):
        assert (gt is None) == (wt is None)
        if wt is not None:
            _close(gt, wt, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["meta16", "meta8", "meta4", "c48", "subtile"])
@pytest.mark.parametrize("offsets", ["noise", "wide"])
def test_tangent_outputs_are_deterministic(cuda, name, offsets):
    """K8's output (its tap splits summed by a second pass in a fixed
    order) and K10's offset and mask gradients (summed over each group in
    shared memory, stored once) are the same bits in two runs; K10's grad x
    takes atomics, in any order."""
    x, offset, mask, weight, cot, coff = _tangent_inputs(TANGENT_SHAPES[name], 8, offsets, cuda)
    out1 = dcn.dcn_fwd_tangent(x, offset, mask, weight, coff, 8)
    out2 = dcn.dcn_fwd_tangent(x, offset, mask, weight, coff, 8)
    _, goff1, gmask1 = dcn.dcn_bwd_data_tangent(x, offset, mask, weight, cot, coff, 8)
    _, goff2, gmask2 = dcn.dcn_bwd_data_tangent(x, offset, mask, weight, cot, coff, 8)
    torch.cuda.synchronize()
    assert torch.equal(out1, out2)
    assert torch.equal(goff1, goff2) and torch.equal(gmask1, gmask2)


@pytest.mark.gpu
def test_tangent_wrappers_refuse_bf16(cuda):
    x, offset, mask, weight, _, cot = _inputs(2, 16, 16, 8, 12, 2, cuda, seed=3)
    with pytest.raises(NotImplementedError, match="A.7"):
        dcn.dcn_fwd_tangent(x.bfloat16(), offset.bfloat16(), mask.bfloat16(),
                            weight.bfloat16(), offset.bfloat16(), 2)


def _second_order_case(op, device):
    """A loss sum(op(theta)^2) + sum(theta^3) through the port's autograd
    Function, with theta the flow (K4/K5), the filters (K6/K7) or the
    offsets (K1-K3); the other inputs fixed."""
    if op == "warp":
        x, flow, _ = _warp_inputs(2, 3, 8, 12, device, seed=7)
        return (lambda t: warp.WarpFunction.apply(x, t)), flow
    if op == "duf":
        x, f, _ = _duf_inputs(2, 3, 4, 8, 12, torch.float32, device, seed=7)
        return (lambda t: duf_filter.DufFilterFunction.apply(x, t)), f
    x, offset, mask, weight, bias, _ = _inputs(2, 16, 16, 8, 12, 2, device, seed=7)
    return (lambda t: dcn.DeformConv2dFunction.apply(x, t, mask, weight, bias, 2)), offset


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["dcn", "warp", "duf"])
def test_double_backward_through_the_kernels_raises(cuda, op):
    """The second order through the kernels: the grad-of-grad matches plain
    autograd's (1e-4 of the largest value, fp32 atomics), launching the
    tangent kernels where the op has them (the DCN's K8 and K10 once each,
    the warp's K11 and K12 in one launch), and the third backward raises."""
    fn, theta = _second_order_case(op, cuda)
    x, _, mask, weight, bias, _ = _inputs(2, 16, 16, 8, 12, 2, cuda, seed=7)

    def first(f):
        tt = theta.clone().requires_grad_()
        (gg,) = torch.autograd.grad((f(tt) ** 2).sum() + (tt ** 3).sum(), tt, create_graph=True)
        return tt, gg

    def grad_of_grad(f):
        tt, gg = first(f)
        return torch.autograd.grad(gg.sum(), tt)[0]

    if op == "warp":
        wx = _warp_inputs(2, 3, 8, 12, cuda, seed=7)[0]
        plain = lambda t: grid_sample_ref.warp_nchw(wx, t)  # noqa: E731
    elif op == "duf":
        dx = _duf_inputs(2, 3, 4, 8, 12, torch.float32, cuda, seed=7)[0]
        plain = lambda t: dynamic_upsampling_filter_ref(dx, t)  # noqa: E731
    else:
        plain = lambda o: deform_conv2d_ref(x, o, mask, weight, bias,  # noqa: E731
                                            deformable_groups=2)
    for module in (dcn, warp, duf_filter):
        module.reset_launch_counts()
    got = grad_of_grad(fn)
    counts = {**dcn.launch_counts(), **warp.launch_counts()}
    _close(got, grad_of_grad(plain), 1e-4)
    tangents = {"dcn": {"dcn_fwd_tangent": 1, "dcn_bwd_weight_tangent": 0,
                        "dcn_bwd_data_tangent": 1},
                "warp": {"warp_fwd_tangent": 0, "warp_bwd_tangent": 1}}.get(op, {})
    # Only theta and grad_out need gradients here: the DCN's K8 and K10, no K9;
    # the warp's T and grad flow in one launch.
    assert {k: counts[k] for k in tangents} == tangents, counts
    tt, gg = first(fn)
    third = {"dcn": "K8-K10", "warp": "K11, K12", "duf": "K6, K7"}[op]
    with pytest.raises(RuntimeError, match=f"double backward.*{third}.*second-order"):
        torch.autograd.grad(gg.sum(), tt, create_graph=True)
